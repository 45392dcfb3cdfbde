"""Dry run of the sharded training, prefill and decode steps on a fake
process group: what one device of the production mesh computes, holds
and sends.

Counterpart of ``repro.launch.dryrun``. The reference lowers and
compiles each (arch x shape x mesh) cell with XLA on a forced 512-device
host mesh and reads the HLO. Torch has no HLO: this runs the port's
sharded step itself (``parallel.spmd``: FSDP over "data", HSDP over
"pod", tensor and expert parallelism over "model") for one rank, rank 0,
of a ``fake`` process group as large as the mesh (256 or 512 ranks),
with every tensor a ``FakeTensor``, at the per-rank shapes: one
``train_4k`` step (forward, backward and AdamW), or one sharded prefill
(``prefill_32k``) or decode step (``decode_32k``, ``long_500k``: one
token a row against a cache of ``seq_len`` positions) under
``torch.no_grad()``.
The model is built without weights and nothing is allocated; every
collective returns at once. Prefill attention reaches the flash kernel
through its custom op, whose fake part returns an empty output: nothing
launches, and the ``Meter`` counts the kernel's output, not the plain
version's score matrix.

What a cell records (the reference's JSON schema and file name,
``{arch}__{shape}__{mesh}.json``, so that ``core.demand.from_dryrun`` of
either package reads it):
- ``collectives`` by kind (count, operand bytes, modelled ring bytes on
  the wire), from ``spmd.Recorder``'s log of every collective the step
  issued (FSDP2's own included) through
  ``hlo_analysis.collective_stats_from_log``; ``wire_bytes_per_dev`` and
  ``collective_operand_bytes_per_dev`` their sums;
- ``flops_per_dev`` by ``torch.utils.flop_counter``'s formulas (matrix
  products, remat's recompute included, the flash op at 4 hd a visible
  (q, k) pair), and ``bytes_per_dev``, the bytes every aten op and the
  flash op read and write (views and collectives left out): torch runs
  op by op, so this counts no fusion;
- ``memory``: ``argument_bytes``, the rank's shards of the parameters
  and its batch rows, with the AdamW moments and step for training, and
  for decode the token rows, the position (4 bytes) and the rank's
  cache blocks, and of the parameters and the position only those the
  step reads (:func:`decode_reads`), as XLA keeps no argument its
  program never reads; ``alias_bytes``, the donated arguments (training: all
  but the batch; decode: the caches; prefill: none), each summed from
  the local tensors the step holds; ``peak_live_bytes``, the most bytes
  the rank's live storages held at once over the step (:class:`Meter`,
  on the fake tensors); ``fits_h100_80g`` (below 80e9 bytes);
- ``params``, ``active_params``, ``model_flops`` (6 N D for training, 2
  N D for inference; D a decode step's rows), the useful share of the
  counted flops, and the three roofline ``terms`` at the rates recorded
  under ``rates`` (:data:`RATES`): the card's bf16 peak at its maximum
  clock and its memory rate (NVIDIA H100 80GB HBM3, 700 W, ``PERF.md``),
  and the modelled fabric's link rate (``core.collectives``: 50e9 B/s a
  link) over the pod's 6 links a chip; ``flash_launches``, the kernel's
  launches in the trace (none: its fake part runs).

The step traces every layer, so nothing is extrapolated from shallower
models (the reference's ``extrapolated`` is left out). The port's
sharded step covers every cell the reference writes: every family
(dense, MoE, SSM, hybrid and encoder-decoder: all ten archs) at
``train_4k`` and at a custom training shape, at ``prefill_32k`` and
``decode_32k``, and at ``long_500k``, a decode of one row against a
cache of 524,288 positions (mamba2-2.7b and jamba: the row whole on
every batch rank, jamba's kv cache with its sequence over "data" and
its ``head_dim`` over "model"). A shape not in the arch's ``shapes``
prints the reference's SKIP line with the arch's notes and writes
nothing. ``--shape all`` runs each arch's ``shapes``, as the
reference's CLI does: 64 files with ``--arch all --mesh both``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape decode_32k --mesh single --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --device cpu
"""
from __future__ import annotations

import argparse
import functools
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.specs import batch_specs, decode_specs, \
    local_shape
from repro_torch.parallel.api import Mesh

SHAPE = "train_4k"
MESH_NAMES = {"single": "single_pod_16x16", "multi": "multi_pod_2x16x16"}
# NVIDIA H100 80GB HBM3 (700 W): 132 SMs x 4096 bf16 flops a clock x
# 1.98 GHz, and its HBM3 rate (PERF.md); the fabric's link rate of
# core.collectives.effective_a2a_bandwidth, 6 links a chip (the pod's
# radix)
PEAK_FLOPS = 132 * 4096 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
LINK_BYTES_PER_S = 50e9
LINKS_PER_CHIP = 6
RATES = dict(peak_flops=PEAK_FLOPS, hbm_bytes_per_s=HBM_BYTES_PER_S,
             link_bytes_per_s=LINK_BYTES_PER_S, links_per_chip=LINKS_PER_CHIP)
H100_BYTES = 80e9
# the decode step's position: an int32 scalar argument in the reference
POS_BYTES = 4
# the ops whose bytes and outputs the Meter counts: aten's and the port's
# custom ops (the flash kernel, ``repro_torch::flash_attention``)
OP_NAMESPACES = ("aten", "repro_torch")


class Meter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts, while active, the flops of every aten op that
    ``torch.utils.flop_counter`` has a formula for (matrix products and
    convolutions; ``FlopCounterMode`` itself is not used, as its module
    hooks keep activations alive and would raise the peak), the bytes
    every aten op reads and writes (its tensor inputs and outputs; views
    and collectives left out), and the peak of the bytes held by live
    storages: those of ``tensors`` and of every op's outputs, until
    their storage dies or is resized (FSDP frees a layer's gathered
    weights by resizing their storage to 0)."""

    def __init__(self, tensors=()):
        super().__init__()
        self.flops = self.bytes = 0
        self.live = self.peak = 0
        self._sizes: Dict[int, int] = {}
        for t in tensors:
            self._hold(t)

    def _hold(self, t) -> None:
        from torch.utils._python_dispatch import \
            is_traceable_wrapper_subclass
        if not isinstance(t, torch.Tensor) or \
                is_traceable_wrapper_subclass(t):
            return
        st = t.untyped_storage()
        if id(st) in self._sizes:
            return
        self._sizes[id(st)] = st.nbytes()
        self._grow(st.nbytes())
        weakref.finalize(st, self._drop, id(st))

    def _grow(self, n: int) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)

    def _drop(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _resize(self, st, n: int) -> None:
        old = self._sizes.get(id(st))
        if old is not None:
            self._sizes[id(st)] = n
            self._grow(n - old)

    def __enter__(self):
        orig = self._orig_resize = torch.UntypedStorage.resize_

        def resize_(st, n):
            out = orig(st, n)
            self._resize(st, n)
            return out
        torch.UntypedStorage.resize_ = resize_
        return super().__enter__()

    def __exit__(self, *exc):
        torch.UntypedStorage.resize_ = self._orig_resize
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.namespace in OP_NAMESPACES and not func.is_view:
            for t in torch.utils._pytree.tree_leaves(out):
                self._hold(t)
            flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
            self.bytes += sum(t.numel() * t.element_size() for t in flat
                              if isinstance(t, torch.Tensor))
        return out


def decode_reads(cfg, name: str) -> bool:
    """Whether a decode step reads the parameter ``name``. XLA keeps no
    argument its program never reads (``jax.jit`` prunes them), so the
    reference's decode cells count none of these: an encoder-decoder's
    encoder and its cross attention's k and v projections (the cache
    holds ``ek`` and ``ev``), a vision arch's ``vis_proj``."""
    if cfg.family == "encdec":
        leaf = name.rsplit(".", 1)[-1]
        return not (name.startswith(("enc_blocks.", "enc_ln_f")) or (
            ".xattn." in name and leaf in ("wk", "wv", "bk", "bv")))
    return name != "vis_proj"


def decode_reads_pos(cfg) -> bool:
    """Whether a decode step reads its position: not where every layer is
    a Mamba mixer (no RoPE, no kv cache to write), so that XLA drops the
    reference's ``pos`` argument."""
    from repro_torch.models.lm import layer_kinds
    return cfg.family == "encdec" or any(
        m == "attn" for m, _ in layer_kinds(cfg))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _local(whole: Dict[str, torch.Tensor], spec: Dict[str, tuple],
           mesh: Mesh, device) -> Dict[str, torch.Tensor]:
    """Empty tensors of one device's blocks of ``whole`` under ``spec``."""
    return {k: torch.empty(local_shape(v.shape, spec[k], mesh),
                           dtype=v.dtype, device=device)
            for k, v in whole.items()}


def trace_step(cfg, shape: ShapeConfig, new_mesh: Callable[..., Mesh],
               device) -> Dict:
    """One sharded step of ``cfg`` at ``shape`` as rank 0 of a fake group
    of the mesh's size, under ``FakeTensorMode``: the collective log, the
    flops, bytes, argument and alias bytes and the peak (module
    docstring), and the host seconds it took. ``new_mesh(device_type=
    ...)`` builds the mesh (``make_production_mesh`` or ``make_mesh``):
    called once without a group for its size, then under the group for
    its DeviceMesh. By ``shape.kind``:
    - train: ``spmd.make_step``; the arguments are the parameters, the
      AdamW state and the batch rows, all but the batch donated;
    - prefill: ``launch.steps.make_prefill_step`` on the sharded model;
      the arguments are the parameters and the batch rows (tokens, a
      vision arch's patches), nothing donated;
    - decode: ``make_serve_step`` at the cache's last position; the
      arguments are the parameters it reads, the token rows (B, 1) int32, the
      position (the reference's traced int32 scalar: 4 bytes; the port
      passes a Python int, R6) and the rank's cache blocks
      (``specs.decode_specs``, whose specs the step also takes: a B = 1
      decode holds its rows whole and its kv cache's sequence over
      "data"), the caches donated, as the reference donates them."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.parallel import spmd

    t0 = time.perf_counter()
    device = torch.device(device)
    launched = fa.launches
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=new_mesh().size)
    try:
        mesh = new_mesh(device_type=device.type)
        with FakeTensorMode():
            model = spmd.build(cfg, mesh, device)
            params = list(model.local_params().values())
            if shape.kind == "decode":
                (token, _, caches), (tspec, _, cspec) = decode_specs(
                    cfg, shape, mesh)
                token = _local({"token": token}, {"token": tspec}, mesh,
                               device)["token"]
                caches = _local(caches, cspec, mesh, device)
                donated = list(caches.values())
                args = [p for n, p in model.local_params().items()
                        if decode_reads(cfg, n)] + [token] + donated
                extra = POS_BYTES if decode_reads_pos(cfg) else 0

                def run():
                    steps.make_serve_step(cfg)(model, token,
                                               shape.seq_len - 1, caches,
                                               cspec)
            else:
                whole, spec = batch_specs(cfg, shape, mesh)
                batch = _local(whole, spec, mesh, device)
                extra = 0
                if shape.kind == "prefill":
                    donated = []
                    args = params + list(batch.values())

                    def run():
                        steps.make_prefill_step(cfg)(model, batch)
                else:
                    opt = adamw.init(model.local_params())
                    donated = params + list(opt["m"].values()) + \
                        list(opt["v"].values()) + [opt["step"]]
                    args = donated + list(batch.values())

                    def run():
                        spmd.make_step(adamw.OptConfig())(model, opt, batch)
            rec, meter = spmd.Recorder(), Meter(params + args)
            with meter, rec:
                run()
    finally:
        dist.destroy_process_group()
    return {"log": rec.log, "flops_per_dev": float(meter.flops),
            "bytes_per_dev": float(meter.bytes),
            "alias_bytes": _nbytes(donated),
            "argument_bytes": _nbytes(args) + extra,
            "peak_live_bytes": meter.peak,
            "flash_launches": fa.launches - launched,
            "trace_s": time.perf_counter() - t0}


def run_cell(arch: str, shape: ShapeConfig, mesh_name: str,
             new_mesh: Callable[..., Mesh], device, smoke: bool = False,
             log: bool = False) -> dict:
    """One cell's record (module docstring) on the mesh ``new_mesh``
    builds (:func:`trace_step`); ``smoke`` takes the arch's
    ``smoke_model()``, ``log`` adds the collective log."""
    a = get_config(arch)
    cfg = a.smoke_model() if smoke else a.model
    described = new_mesh()
    chips = described.size
    t = trace_step(cfg, shape, new_mesh, device)
    coll = H.collective_stats_from_log(t["log"])
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name, "opts": "",
           "chips": chips, "kind": shape.kind,
           "mesh_shape": list(described.shape),
           "axis_names": list(described.axis_names),
           "global_batch": shape.global_batch, "seq_len": shape.seq_len,
           "smoke": smoke, "device": str(device),
           "trace_s": t["trace_s"], "flash_launches": t["flash_launches"],
           "flops_per_dev": t["flops_per_dev"],
           "bytes_per_dev": t["bytes_per_dev"], "collectives": coll,
           "wire_bytes_per_dev": sum(v["wire_bytes"] for v in coll.values()),
           "collective_operand_bytes_per_dev":
               sum(v["operand_bytes"] for v in coll.values()),
           "memory": {"argument_bytes": t["argument_bytes"],
                      "alias_bytes": t["alias_bytes"],
                      "peak_live_bytes": t["peak_live_bytes"],
                      "fits_h100_80g": t["peak_live_bytes"] < H100_BYTES},
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    rec["model_flops"] = H.model_flops(rec["active_params"], tokens,
                                       shape.kind)
    total = rec["flops_per_dev"] * chips
    rec["useful_flop_ratio"] = rec["model_flops"] / total if total else 0.0
    rec["rates"] = RATES
    rec["terms"] = H.roofline_terms(rec["flops_per_dev"], rec["bytes_per_dev"],
                                    rec["wire_bytes_per_dev"], chips, **RATES)
    if log:
        rec["collective_log"] = [list(r) for r in t["log"]]
    return rec


def cells(args) -> List[Tuple[str, Callable[..., Mesh]]]:
    """(mesh name, mesh builder) of each mesh the arguments ask for."""
    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        names = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        return [("mesh_" + "x".join(map(str, shape)),
                 functools.partial(make_mesh, names, shape))]
    keys = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    return [(MESH_NAMES[k], functools.partial(make_production_mesh,
                                              multi_pod=k == "multi"))
            for k in keys]


def _arch_shapes(archs: List[str], shape_name: str, custom):
    """The (arch, shape) cells to run, in order, printing the reference's
    SKIP line (the arch's notes) for a shape not in the arch's
    ``shapes``. ``custom`` (a training shape) runs for every arch."""
    for arch in archs:
        a = get_config(arch)
        names = list(a.shapes) if shape_name == "all" else [shape_name]
        for shape in [custom] if custom else [SHAPES[n] for n in names]:
            if not custom and shape.name not in a.shapes:
                print(f"SKIP {arch} x {shape.name}: {a.notes}", flush=True)
                continue
            yield arch, shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default=SHAPE, choices=list(SHAPES) + ["all"],
                    help="a shape, or all: every shape in each arch's "
                         "shapes")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mesh-shape", default="",
                    help="a (data, model) or (pod, data, model) mesh, e.g. "
                         "2,2, in place of --mesh")
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch of a custom training shape")
    ap.add_argument("--seq", type=int, default=0,
                    help="sequence length of a custom training shape")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default CUDA)")
    ap.add_argument("--outdir", default="dryrun_out")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--log", action="store_true",
                    help="also write the collective log")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    if bool(args.batch) != bool(args.seq):
        ap.error("a custom shape takes both --batch and --seq")
    custom = None
    if args.batch:
        custom = ShapeConfig(f"custom_b{args.batch}_s{args.seq}", args.seq,
                             args.batch, "train")
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = list_archs() if args.arch == "all" else [args.arch]
    failed = 0
    for arch, shape in _arch_shapes(archs, args.shape, custom):
        for mesh_name, new_mesh in cells(args):
            out = outdir / f"{arch}__{shape.name}__{mesh_name}.json"
            if out.exists() and not args.force:
                print(f"cached {out.name}", flush=True)
                continue
            print(f"=== {arch} x {shape.name} x {mesh_name}", flush=True)
            try:
                rec = run_cell(arch, shape, mesh_name, new_mesh, device,
                               log=args.log)
            except Exception as e:
                failed += 1
                print(f"    FAIL {e}\n{traceback.format_exc()}", flush=True)
                continue
            print(f"    ok trace={rec['trace_s']:.1f}s "
                  f"peak={rec['memory']['peak_live_bytes'] / 1e9:.2f}GB "
                  f"wire={rec['wire_bytes_per_dev'] / 1e9:.3f}GB "
                  f"dom={rec['terms']['dominant']}", flush=True)
            out.write_text(json.dumps(rec, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
