"""The port's serving dry run of the SSM, hybrid and encoder-decoder
families and of a B = 1 decode (``launch/dryrun.py`` at
``prefill_32k``, ``decode_32k`` and ``long_500k``: the sharded
``prefill`` and ``decode_step`` traced as rank 0 of a fake group)
against the reference's.

- At the ``smoke_model()`` of mamba2-2.7b, jamba-v0.1-52b and
  seamless-m4t-medium on a (2, 2) ("data", "model") mesh, at a prefill
  and a decode shape of 4 x 64, and of mamba2-2.7b and jamba at a decode
  of one row against 64 positions (``long_500k``'s layout: the row
  whole on every rank, jamba's kv cache with its sequence over "data"),
  also with one kv head (its ``head_dim`` columns over "model" at the
  same time): the port's ``argument_bytes`` and ``alias_bytes`` equal
  XLA's memory analysis of the reference's ``build_lowered`` exactly.
  The reference runs in a subprocess with 512 forced host devices
  (``repro.launch.dryrun`` sets them as it is imported). XLA keeps no
  argument its program never reads, so a decode counts neither
  seamless's encoder and cross attention k and v projections nor
  mamba2's position (``dryrun.decode_reads``).
- One production cell of the new layout (jamba-v0.1-52b x long_500k x
  single_pod_16x16) through the CLI under the fake group of 256 ranks:
  the reference's keys, ``chips`` 256, one row, no flash launch, the
  cache blocks donated; ``from_dryrun`` of both packages reads it.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import base as PB, registry as preg
from repro_torch.launch import dryrun as PD, specs as PS
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import api as PAPI

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# each cell: (arch, changes to its smoke config, kind, global batch)
CELLS = {
    "mamba2 prefill": ("mamba2-2.7b", {}, "prefill", 4),
    "mamba2 decode": ("mamba2-2.7b", {}, "decode", 4),
    "mamba2 decode B1": ("mamba2-2.7b", {}, "decode", 1),
    "jamba prefill": ("jamba-v0.1-52b", {}, "prefill", 4),
    "jamba decode": ("jamba-v0.1-52b", {}, "decode", 4),
    "jamba decode B1": ("jamba-v0.1-52b", {}, "decode", 1),
    "jamba kv1 decode B1": ("jamba-v0.1-52b", {"n_kv_heads": 1}, "decode",
                            1),
    "seamless prefill": ("seamless-m4t-medium", {}, "prefill", 4),
    "seamless decode": ("seamless-m4t-medium", {}, "decode", 4),
}
SEQ = 64
REFERENCE = """
import dataclasses, json, sys
import repro.launch.dryrun as D
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs.base import ShapeConfig
from repro.configs.registry import get_config
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
for name, (arch, changes, kind, B) in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(get_config(arch).smoke_model(), **changes)
    lowered, _ = D.build_lowered(
        cfg, ShapeConfig(kind + "_small", int(sys.argv[2]), B, kind), mesh)
    ma = lowered.compile().memory_analysis()
    out[name] = [int(ma.argument_size_in_bytes),
                 int(ma.alias_size_in_bytes)]
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([SRC] + sys.path),
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def reference_bytes():
    out = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(CELLS),
                          str(SEQ)], env=dict(_env(), JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _local_bytes(tensors, spec, mesh):
    return sum(int(torch.Size(PS.local_shape(t.shape, spec[n], mesh))
                   .numel()) * t.element_size() for n, t in tensors.items())


@pytest.mark.parametrize("cell", list(CELLS))
def test_argument_and_alias_bytes_equal_xla(cell, reference_bytes):
    """Exactly XLA's; the parts are what ``specs`` gives: the parameters
    (a decode's those it reads), the rows (a B = 1 token whole), the
    position where the step reads it, the cache blocks donated."""
    arch, changes, kind, B = CELLS[cell]
    cfg = dataclasses.replace(preg.get_config(arch).smoke_model(), **changes)
    shape = PB.ShapeConfig(kind + "_small", SEQ, B, kind)
    new_mesh = functools.partial(make_mesh, ("data", "model"), (2, 2))
    t = PD.trace_step(cfg, shape, new_mesh, "cpu")
    assert [t["argument_bytes"], t["alias_bytes"]] == reference_bytes[cell]
    mesh = PAPI.Mesh(("data", "model"), (2, 2))
    params, pspec, _, _ = PS.model_state_specs(cfg, mesh)
    if kind == "prefill":
        batch, bspec = PS.batch_specs(cfg, shape, mesh)
        assert t["alias_bytes"] == 0
        assert t["argument_bytes"] == _local_bytes(params, pspec, mesh) + \
            _local_bytes(batch, bspec, mesh)
    else:
        (token, _, caches), (tspec, _, cspec) = PS.decode_specs(cfg, shape,
                                                                mesh)
        read = {n: p for n, p in params.items() if PD.decode_reads(cfg, n)}
        cache = _local_bytes(caches, cspec, mesh)
        assert t["alias_bytes"] == cache
        assert t["argument_bytes"] == _local_bytes(read, pspec, mesh) + \
            _local_bytes({"t": token}, {"t": tspec}, mesh) + cache + \
            (PD.POS_BYTES if PD.decode_reads_pos(cfg) else 0)
        if B == 1:
            assert tspec == () and all(
                not s or s[1] is None for n, s in cspec.items())
            if "k" in cspec:
                assert cspec["k"][2] == "data"
    assert t["log"] and t["flops_per_dev"] > 0
    assert t["flash_launches"] == 0
    assert t["peak_live_bytes"] > t["argument_bytes"]


def test_decode_reads_leave_out_what_the_step_never_reads():
    seamless = preg.get_config("seamless-m4t-medium").smoke_model()
    assert not PD.decode_reads(seamless, "enc_blocks.0.attn.wq")
    assert not PD.decode_reads(seamless, "enc_ln_f")
    assert not PD.decode_reads(seamless, "dec_blocks.1.xattn.wk")
    assert PD.decode_reads(seamless, "dec_blocks.1.xattn.wq")
    assert PD.decode_reads(seamless, "dec_blocks.1.attn.wk")
    internvl = preg.get_config("internvl2-2b").smoke_model()
    assert not PD.decode_reads(internvl, "vis_proj")
    assert PD.decode_reads(internvl, "emb")
    assert not PD.decode_reads_pos(preg.get_config("mamba2-2.7b").model)
    for arch in ("jamba-v0.1-52b", "seamless-m4t-medium", "qwen2.5-3b"):
        assert PD.decode_reads_pos(preg.get_config(arch).model)


def test_cli_long_500k_cell_feeds_from_dryrun(tmp_path):
    """jamba-v0.1-52b x long_500k x single_pod_16x16: one row against a
    cache of 524,288 positions, 32,768 a data rank; the softmax's
    all-reduces over "data" beside FSDP's gathers; both packages'
    ``from_dryrun`` read its collectives."""
    from repro.core import demand as JD
    from repro_torch.core import demand as PDM
    from repro_torch.launch import hlo_analysis as PH
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "jamba-v0.1-52b", "--shape", "long_500k", "--mesh", "single",
         "--device", "cpu", "--outdir", str(tmp_path)], env=_env(),
        capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "SKIP" not in out.stdout and "FAIL" not in out.stdout
    f = tmp_path / "jamba-v0.1-52b__long_500k__single_pod_16x16.json"
    assert os.listdir(tmp_path) == [f.name]
    rec = json.loads(f.read_text())
    assert rec["chips"] == 256 and rec["kind"] == "decode"
    assert rec["global_batch"] == 1 and rec["seq_len"] == 524288
    assert rec["flash_launches"] == 0
    assert rec["model_flops"] == PH.model_flops(rec["active_params"], 1,
                                                "decode")
    mesh = PAPI.Mesh(("data", "model"), (16, 16))
    cfg = preg.get_config("jamba-v0.1-52b").model
    (_, _, caches), (_, _, cspec) = PS.decode_specs(
        cfg, PB.SHAPES["long_500k"], mesh)
    assert cspec["k"] == (None, None, "data", None, "model")
    mem = rec["memory"]
    assert mem["alias_bytes"] == _local_bytes(caches, cspec, mesh)
    assert 0 < mem["alias_bytes"] < mem["argument_bytes"] \
        < mem["peak_live_bytes"]
    assert set(rec["collectives"]) == {"all-gather", "all-reduce"}
    spec = (4, 4, 8)
    want = PDM.from_mix(PDM.Pod(spec), {
        k: v["wire_bytes"] for k, v in rec["collectives"].items()})
    for fn in (PDM.from_dryrun, JD.from_dryrun):
        got = fn(spec, "jamba-v0.1-52b", "long_500k",
                 dryrun_dir=str(tmp_path))
        assert (got.w_same_cube, got.w_ring, got.w_uniform) == \
            (want.w_same_cube, want.w_ring, want.w_uniform)
