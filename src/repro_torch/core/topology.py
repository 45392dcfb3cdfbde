"""TPU v4/5p pod fabric model: cubes, OCS port groups, PT/PDTT baselines.

A job of chip dims (X, Y, Z) (each a multiple of 4, or exactly 4) is built
from 4x4x4 electrically-wired cubes. Chips on a cube face expose one optical
port per face axis; ports are grouped by (axis, in-cube face position) into
48 OCS domains ("colors"), and an optical circuit may connect any two ports
of the same OCS (paper Section 2.2). A topology is the fixed electrical mesh
plus a perfect matching per OCS group.

Port of ``repro.core.topology``: numpy on the host, except the all-pairs
hop matrix, which :func:`bfs_all_pairs` computes on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

CUBE = 4
N_POS = CUBE * CUBE           # 16 face positions per axis
N_COLORS = 3 * N_POS          # 48 OCS domains


@dataclasses.dataclass(frozen=True)
class Pod:
    dims: Tuple[int, int, int]            # chips per axis

    def __post_init__(self):
        for d in self.dims:
            assert d == CUBE or d % CUBE == 0, f"bad dim {d}"

    @property
    def n(self) -> int:
        x, y, z = self.dims
        return x * y * z

    @property
    def cube_dims(self) -> Tuple[int, int, int]:
        return tuple(d // CUBE for d in self.dims)

    @property
    def n_cubes(self) -> int:
        cx, cy, cz = self.cube_dims
        return cx * cy * cz

    # ---- chip indexing ----------------------------------------------------
    def node_id(self, x, y, z):
        X, Y, Z = self.dims
        return (x % X) + X * ((y % Y) + Y * (z % Z))

    def coords(self, i):
        X, Y, Z = self.dims
        return i % X, (i // X) % Y, i // (X * Y)

    def all_coords(self) -> np.ndarray:
        X, Y, Z = self.dims
        i = np.arange(self.n)
        return np.stack([i % X, (i // X) % Y, i // (X * Y)], axis=1)

    def cube_of(self, i) -> Tuple[int, int, int]:
        x, y, z = self.coords(i)
        return x // CUBE, y // CUBE, z // CUBE

    def incube(self, i) -> Tuple[int, int, int]:
        x, y, z = self.coords(i)
        return x % CUBE, y % CUBE, z % CUBE


def electrical_edges(pod: Pod) -> np.ndarray:
    """Intra-cube 3D mesh links (fixed copper), as (E, 2) with u < v."""
    edges = []
    X, Y, Z = pod.dims
    for i in range(pod.n):
        x, y, z = pod.coords(i)
        for axis, (dx, dy, dz) in enumerate([(1, 0, 0), (0, 1, 0),
                                             (0, 0, 1)]):
            nx, ny, nz = x + dx, y + dy, z + dz
            if nx >= X or ny >= Y or nz >= Z:
                continue
            # stay within the same cube
            if (nx // CUBE, ny // CUBE, nz // CUBE) != \
               (x // CUBE, y // CUBE, z // CUBE):
                continue
            edges.append((i, pod.node_id(nx, ny, nz)))
    return np.array(sorted(edges), dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class Port:
    chip: int
    axis: int          # 0, 1, 2
    sign: int          # -1 (low face) or +1 (high face)
    pos: int           # 0..15 position within the face (other two coords)
    color: int         # OCS domain = axis * 16 + pos


def ports(pod: Pod) -> List[Port]:
    out = []
    for i in range(pod.n):
        ix, iy, iz = pod.incube(i)
        inc = (ix, iy, iz)
        for axis in range(3):
            o1, o2 = [inc[a] for a in range(3) if a != axis]
            pos = o1 * CUBE + o2
            if inc[axis] == 0:
                out.append(Port(i, axis, -1, pos, axis * N_POS + pos))
            elif inc[axis] == CUBE - 1:
                out.append(Port(i, axis, +1, pos, axis * N_POS + pos))
    return out


def ocs_groups(pod: Pod) -> Dict[int, List[Port]]:
    groups: Dict[int, List[Port]] = {c: [] for c in range(N_COLORS)}
    for p in ports(pod):
        groups[p.color].append(p)
    return groups


def valid_optical_pairs_arrays(pod: Pod
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """All OCS-feasible optical edges as ``(u, v, color)`` arrays, u < v.

    Vectorised per color: a port list is sorted by chip (one port per
    (chip, axis), so chips are distinct within a group) and the upper
    triangle of its chip array enumerates every circuit-connectable pair
    -- identical output order to the old ``itertools.combinations`` loop.
    """
    us, vs, cs = [], [], []
    for color, plist in ocs_groups(pod).items():
        chips = np.array([p.chip for p in plist], np.int32)
        if len(chips) < 2:
            continue
        iu, iv = np.triu_indices(len(chips), k=1)
        us.append(chips[iu])
        vs.append(chips[iv])
        cs.append(np.full(len(iu), color, np.int32))
    if not us:
        z = np.zeros(0, np.int32)
        return z, z, z
    return np.concatenate(us), np.concatenate(vs), np.concatenate(cs)


def valid_optical_pairs(pod: Pod) -> List[Tuple[int, int, int]]:
    """All OCS-feasible optical edges as (u, v, color), u < v chips.
    Any two distinct ports of the same OCS group may be circuit-connected."""
    u, v, c = valid_optical_pairs_arrays(pod)
    return list(zip(u.tolist(), v.tolist(), c.tolist()))


# ---------------------------------------------------------------------------
# Baseline topologies
# ---------------------------------------------------------------------------


def pt_optical(pod: Pod) -> List[Tuple[int, int, int]]:
    """Prismatic torus: per OCS group, chain the cubes into a ring along the
    group's axis (single-cube axes wrap a cube's own faces -> 4-torus)."""
    edges = []
    X, Y, Z = pod.dims
    for p in ports(pod):
        if p.sign != +1:
            continue
        x, y, z = pod.coords(p.chip)
        c = [x, y, z]
        c[p.axis] = (c[p.axis] + 1) % pod.dims[p.axis]
        v = pod.node_id(*c)
        u = p.chip
        edges.append((min(u, v), max(u, v), p.color))
    return sorted(set(edges))


def pdtt_lattice(pod: Pod, long_axis: Optional[int] = None,
                 shifts: Optional[Tuple[int, int]] = None):
    """The prismatic doubly twisted torus (Camara et al. [9]) is the Cayley
    graph of Z^3 modulo the lattice L spanned by
        X ex + s0 ez,   Y ey + s1 ez,   Z ez
    (for long axis z): the wraps of the SHORT dimensions are twisted along
    the LONG dimension, by half its length by default."""
    dims = pod.dims
    la = int(np.argmax(dims)) if long_axis is None else long_axis
    sa = [a for a in range(3) if a != la]
    if shifts is None:
        shifts = (dims[la] // 2, dims[la] // 2)
    return la, sa, shifts


def _pdtt_reduce(coords: np.ndarray, dims, la, sa, shifts) -> np.ndarray:
    """Reduce integer coordinates modulo the PDTT lattice."""
    c = coords.astype(np.int64).copy()
    for a, s in zip(sa, shifts):
        w = c[:, a] // dims[a]
        c[:, a] -= w * dims[a]
        c[:, la] += w * s
    c[:, la] %= dims[la]
    return c


def twisted_torus_optical(pod: Pod, long_axis: Optional[int] = None,
                          shifts: Optional[Tuple[int, int]] = None
                          ) -> List[Tuple[int, int, int]]:
    """Prismatic doubly twisted torus baseline (deployed TPU v4 variant).
    NOTE: twisted wraps connect ports of *different* OCS positions --
    allowed for the hardwired baseline only; TONS synthesis keeps strict
    same-color matchings (DESIGN.md)."""
    la, sa, shifts = pdtt_lattice(pod, long_axis, shifts)
    dims = pod.dims
    edges = []
    for p in ports(pod):
        if p.sign != +1:
            continue
        c = np.array([list(pod.coords(p.chip))])
        c[0, p.axis] += 1
        c = _pdtt_reduce(c, dims, la, sa, shifts)[0]
        v = pod.node_id(*c)
        u = p.chip
        edges.append((min(u, v), max(u, v), p.color))
    return sorted(set(edges))


def random_matching_optical(pod: Pod, seed: int = 0
                            ) -> List[Tuple[int, int, int]]:
    """TPU-constrained random topology: uniform random perfect matching per
    OCS group (the paper's random baseline in Fig. 2)."""
    rng = np.random.default_rng(seed)
    edges = []
    for color, plist in ocs_groups(pod).items():
        idx = rng.permutation(len(plist))
        for a in range(0, len(idx) - 1, 2):
            pa, pb = plist[idx[a]], plist[idx[a + 1]]
            if pa.chip == pb.chip:  # cannot happen (one port per axis/chip)
                continue
            u, v = sorted((pa.chip, pb.chip))
            edges.append((u, v, color))
    return sorted(edges)


# ---------------------------------------------------------------------------
# Graphs and symmetry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Topology:
    pod: Pod
    optical: List[Tuple[int, int, int]]        # (u, v, color)
    name: str = "topo"

    @property
    def n(self) -> int:
        return self.pod.n

    def edges(self) -> np.ndarray:
        """All undirected edges (E, 2), electrical + optical."""
        e = electrical_edges(self.pod)
        o = np.array([(u, v) for u, v, _ in self.optical], dtype=np.int32)
        if len(o) == 0:
            return e
        return np.concatenate([e, o], axis=0)

    def edge_colors(self) -> np.ndarray:
        """-1 for electrical, OCS color id for optical."""
        e = electrical_edges(self.pod)
        return np.concatenate([
            np.full(len(e), -1, np.int32),
            np.array([c for _, _, c in self.optical], np.int32)])

    def adjacency(self) -> List[List[int]]:
        adj: List[List[int]] = [[] for _ in range(self.n)]
        for u, v in self.edges():
            adj[u].append(int(v))
            adj[v].append(int(u))
        return adj


def cube_translations(pod: Pod) -> np.ndarray:
    """Node permutations for all cube-grid translations, (n_cubes, n)."""
    cx, cy, cz = pod.cube_dims
    X, Y, Z = pod.dims
    coords = pod.all_coords()
    perms = []
    for tx in range(cx):
        for ty in range(cy):
            for tz in range(cz):
                nx = (coords[:, 0] + CUBE * tx) % X
                ny = (coords[:, 1] + CUBE * ty) % Y
                nz = (coords[:, 2] + CUBE * tz) % Z
                perms.append(nx + X * (ny + Y * nz))
    return np.array(perms, dtype=np.int32)


def torus_translations(pod: Pod, twisted: bool = False,
                       long_axis: Optional[int] = None) -> np.ndarray:
    """Full chip-level translation group of the (twisted) torus: these are
    Cayley graphs of Z^3 modulo a lattice, so all translations (reduced
    modulo that lattice) are automorphisms."""
    X, Y, Z = pod.dims
    dims = pod.dims
    coords = pod.all_coords()
    la, sa, shift = pdtt_lattice(pod, long_axis)
    perms = set()
    for tx in range(X):
        for ty in range(Y):
            for tz in range(Z):
                c = coords + np.array([tx, ty, tz])
                if twisted:
                    c = _pdtt_reduce(c, dims, la, sa, shift)
                else:
                    c = c % np.array(dims)
                perms.add(tuple(c[:, 0] + X * (c[:, 1] + Y * c[:, 2])))
    return np.array(sorted(perms), dtype=np.int32)


def pt(podspec: Tuple[int, int, int]) -> Topology:
    pod = Pod(podspec)
    return Topology(pod, pt_optical(pod), name=f"PT {podspec}")


def pdtt(podspec: Tuple[int, int, int],
         long_axis: Optional[int] = None) -> Topology:
    pod = Pod(podspec)
    return Topology(pod, twisted_torus_optical(pod, long_axis),
                    name=f"PDTT {podspec}")


def random_topology(podspec: Tuple[int, int, int], seed: int = 0) -> Topology:
    pod = Pod(podspec)
    return Topology(pod, random_matching_optical(pod, seed),
                    name=f"RAND {podspec} s{seed}")


# ---------------------------------------------------------------------------
# Simple graph metrics (all pairs: the (min,+) APSP kernel; rows: host BFS)
# ---------------------------------------------------------------------------


def bfs_all_pairs(topo: Topology, sources: Optional[np.ndarray] = None,
                  device=None) -> np.ndarray:
    """Hop distances from each source (default: all), float64, ``inf`` for
    unreachable pairs -- the same matrix as scipy's BFS.

    With ``sources=None`` the whole matrix comes from the (min,+) APSP
    kernel on ``device`` (``None`` = CUDA; the plain torch version on a
    CPU device), with values >= 1e8 mapped back to ``inf``. Calls with
    explicit ``sources`` (one BFS root, a cube's 64 chips) keep the host
    BFS via scipy csgraph: a few rows do not pay for an n^3 closure.
    """
    if sources is None:
        from repro_torch.kernels import ops
        d = ops.hop_distances(topo.edges(), topo.n, device=device)
        d = d.cpu().numpy().astype(np.float64)
        d[d >= ops.UNREACHABLE] = np.inf
        return d
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    e = topo.edges()
    n = topo.n
    a = sp.csr_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    a = a + a.T
    return csg.shortest_path(a, method="D", unweighted=True,
                             indices=sources)


def diameter_avg_hops(topo: Topology, device=None) -> Tuple[int, float]:
    """Exploit cube-translation symmetry: BFS from one cube only. Without
    that symmetry (or at n <= 64) the APSP runs on ``device``."""
    perms = cube_translations(topo.pod)
    srcs = np.arange(64) if len(perms) > 1 else None
    if topo.n <= 64:
        srcs = None
    d = bfs_all_pairs(topo, sources=srcs, device=device)
    finite = d[np.isfinite(d)]
    diam = int(finite.max())
    # average over ordered pairs excluding self (paper counts avg hops)
    total = finite.sum()
    cnt = finite.size - d.shape[0]  # minus self-distances (zeros)
    return diam, float(total / cnt)
