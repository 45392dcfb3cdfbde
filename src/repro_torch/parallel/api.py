"""Mesh context and sharding helpers.

Counterpart of ``repro.parallel.api``. A mesh here is a description --
axis names and sizes (:class:`Mesh`) -- and, when a process group is up,
the ``torch.distributed`` ``DeviceMesh`` that holds it. A spec is a plain
tuple, the counterpart of ``PartitionSpec``: one entry per leading
dimension, each ``None``, an axis name or a tuple of axis names.

``filter_spec`` reads only the names and sizes, so a spec can be
resolved against a described (16, 16) or (2, 16, 16) mesh with no
devices. ``named`` turns a spec into DTensor placements (the counterpart
of ``NamedSharding``) and ``wsc`` redistributes a DTensor to them; a plain
tensor passes ``wsc`` unchanged, which is why the models' call sites of
the reference's ``wsc`` are left out of the port (``models.layers``).

Under a default process group the batch is spread over its ranks
(:func:`processes`): ``train.loop.make_step`` gives each rank its rows,
and each rank holds an equal share of the mesh's batch axes ("pod",
"data") in rank order; the model axis is not split over processes.
The sharded step (``parallel.spmd``) does split it: its layers enter
and leave work split over a process group through ``column_input``,
``row_output`` and ``summed``, autograd functions around one
all-reduce each.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh; ``device_mesh`` the
    DeviceMesh over the default group's ranks, if any."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device_mesh: Any = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.shape} differ in length")

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.sizes.get(name, 1)

    @property
    def batch_shards(self) -> int:
        """pod x data: the data-parallel shards of the whole mesh."""
        return math.prod(self.axis_size(a) for a in BATCH_AXES)


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


class mesh_context:
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = get_mesh()
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_mesh(self.prev)


def filter_spec(spec_elements, mesh: Optional[Mesh] = None,
                shape: Optional[Sequence[int]] = None) -> tuple:
    """Drop axis names not in the mesh; where a dimension of ``shape`` does
    not divide by its axes' total size, drop trailing axes until it
    does; strip trailing ``None``s. ``()`` without a mesh."""
    mesh = mesh or _MESH
    if mesh is None:
        return ()
    sizes = mesh.sizes
    out = []
    for i, e in enumerate(spec_elements):
        if e is None:
            out.append(None)
            continue
        axes = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                     if a in sizes)
        if shape is not None:
            while axes and shape[i] % math.prod(sizes[a] for a in axes):
                axes = axes[:-1]
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def named(spec_elements, shape=None, mesh: Optional[Mesh] = None) -> list:
    """The DTensor placements of a spec, one per mesh dimension:
    ``Shard(i)`` where entry i of the filtered spec names that axis,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = mesh or _MESH
    place = [Replicate() for _ in mesh.axis_names]
    for i, e in enumerate(filter_spec(spec_elements, mesh, shape)):
        for a in (e if isinstance(e, tuple) else (e,)) if e else ():
            place[mesh.axis_names.index(a)] = Shard(i)
    return place


def wsc(x, *spec_elements):
    """A DTensor redistributed to ``named(spec, x.shape)`` on the context
    mesh; any other tensor, or any tensor without a mesh that holds a
    DeviceMesh, unchanged."""
    mesh = _MESH
    if mesh is None or mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh.device_mesh,
                          named(spec_elements, x.shape, mesh))


# --- the processes that share the batch -------------------------------------


def process_group() -> Optional[Tuple[int, int]]:
    """(rank, world size) of the default process group; None without
    one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def processes() -> int:
    """The ranks that share each batch: the default group's world size,
    1 without a group. Every rank runs the same layers in the same
    order, so each collective that the layers enter when this is above 1
    is entered by all of them."""
    group = process_group()
    return 1 if group is None else group[1]


def local_shards(mesh: Mesh) -> int:
    """The batch shards (pod x data) of ``mesh`` that this process holds:
    an equal share over :func:`processes`."""
    w = processes()
    if mesh.batch_shards % w:
        raise ValueError(f"{mesh.batch_shards} batch shards do not split "
                         f"over {w} processes")
    return mesh.batch_shards // w


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order,
    differentiable: a rank's rows get the sum of every rank's cotangent
    for them."""
    from torch.distributed.nn.functional import all_gather
    return torch.cat(all_gather(t.contiguous()), dim=0)


# --- collectives at module boundaries (parallel.spmd) -----------------------


def _reduced(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``t`` summed over ``group``."""
    import torch.distributed as dist
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _ColumnInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _RowOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Summed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


def column_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` where it enters work split over ``group`` (a column-parallel
    product): the identity forward; the backward sums the ranks' partial
    gradients. ``x`` itself without a group."""
    return x if group is None else _ColumnInput.apply(x, group)


def row_output(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial results of a row-parallel product summed over
    ``group``; every rank holds the sum, and the backward passes each
    rank's gradient on as it is. ``x`` itself without a group."""
    return x if group is None else _RowOutput.apply(x, group)


def summed(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward, and its gradient summed over
    it backward: for a value every rank then uses alike (the MoE's
    load-balancing sums over the batch shards). ``x`` without a group."""
    return x if group is None else _Summed.apply(x, group)
