"""The port's serving dry run (``launch/dryrun.py`` at ``prefill_32k`` and
``decode_32k``: ``parallel.spmd.ShardedLM.prefill`` and ``decode_step``
traced as rank 0 of a fake group) against the reference's, and the flash
kernel as the custom op that fake tensors trace.

- The custom op ``repro_torch::flash_attention``: on the CPU the plain
  version bit for bit; on fake CUDA tensors an empty output laid out as
  the kernel's (q's strides), with no launch and no memory; its flop
  formula 4 hd a visible (q, k) pair, the count of ``PERF.md``'s bound;
  the dry run's ``Meter`` counts its output as live storage and its
  operands' bytes, not the plain version's score matrix.
- At the ``smoke_model()`` of qwen2.5-3b and deepseek-moe-16b on a (2, 2)
  ("data", "model") mesh, at a prefill and a decode shape of 4 x 64: the
  port's ``argument_bytes`` and ``alias_bytes`` (parameters and batch
  rows; for decode also the token rows, the 4-byte position and the
  cache blocks, the caches donated) equal XLA's memory analysis of the
  reference's ``build_lowered`` exactly. The reference runs in a
  subprocess with 512 forced host devices (``repro.launch.dryrun`` sets
  them as it is imported).
- One production serving cell (qwen2.5-3b x decode_32k x
  single_pod_16x16, seconds on a CPU) through the CLI under the fake
  group of 256 ranks: the reference's file name and keys, ``chips``
  256, no flash launch; ``from_dryrun`` of both packages reads it. An
  SSM family's serving cell (mamba2-2.7b x decode_32k) runs and writes
  its file (``test_torch_dryrun_serve_families.py`` holds those
  families' cells to XLA's); a shape not in the arch's ``shapes``
  (qwen2.5-3b x long_500k) prints the reference's SKIP line with the
  arch's notes and writes nothing.
- ``--shape all`` over the registry: every shape of each arch's
  ``shapes``, 64 files on the two meshes, no SKIP line.
"""
import functools
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from repro_torch.configs import base as PB, registry as preg
from repro_torch.kernels import flash_attention as kfa, ops, ref
from repro_torch.launch import dryrun as PD, specs as PS
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import api as PAPI

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SERVE_ARCHS = ("qwen2.5-3b", "deepseek-moe-16b")
KINDS = ("prefill", "decode")
REFERENCE = """
import json, sys
import repro.launch.dryrun as D
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs.base import ShapeConfig
from repro.configs.registry import get_config
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
for kind in ("prefill", "decode"):
    shape = ShapeConfig(kind + "_small", 64, 4, kind)
    for arch in sys.argv[1:]:
        lowered, _ = D.build_lowered(get_config(arch).smoke_model(), shape,
                                     mesh)
        ma = lowered.compile().memory_analysis()
        out[arch + " " + kind] = [int(ma.argument_size_in_bytes),
                                  int(ma.alias_size_in_bytes)]
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([SRC] + sys.path),
                OMP_NUM_THREADS="1")


def _qkv(B, Hq, Hkv, S, hd, dtype=torch.float32, seed=0):
    """Normal q, k, v as the model hands them over: (B, S, H, hd)
    activations viewed as (B, H, S, hd)."""
    g = torch.Generator().manual_seed(seed)

    def one(H):
        return torch.randn((B, S, H, hd), generator=g).to(dtype) \
            .transpose(1, 2)
    return one(Hq), one(Hkv), one(Hkv)


@pytest.mark.parametrize("causal", [True, False])
def test_custom_op_on_cpu_is_the_plain_version(causal):
    q, k, v = _qkv(2, 4, 2, 48, 64, torch.bfloat16)
    got = torch.ops.repro_torch.flash_attention(q, k, v, causal)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal))
    assert torch.equal(ops.flash_attention(q, k, v, causal), got)
    assert kfa.launches == 0


@pytest.mark.parametrize("shape", [(2, 16, 2, 32768, 128),
                                   (1, 32, 8, 4096, 160)])
def test_custom_op_traces_fake_cuda_tensors(shape):
    """The model's transposed (B, S, H, hd) views at a production size:
    the output has q's shape, dtype and strides on the fake device, and
    nothing launches."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    B, Hq, Hkv, S, hd = shape
    with FakeTensorMode():
        q, k, v = (torch.empty((B, S, H, hd), dtype=torch.bfloat16,
                               device="cuda").transpose(1, 2)
                   for H in (Hq, Hkv, Hkv))
        out = ops.flash_attention(q, k, v)
    assert isinstance(out, FakeTensor) and out.device.type == "cuda"
    assert out.shape == q.shape and out.stride() == q.stride()
    assert out.dtype == torch.bfloat16
    assert kfa.launches == 0


@pytest.mark.parametrize("Sq, Skv, causal", [(64, 64, True), (40, 64, True),
                                             (64, 40, True), (64, 40, False)])
def test_flop_formula_counts_visible_pairs(Sq, Skv, causal):
    """4 hd flops a visible (q, k) pair of each head, the top-left mask's
    pairs counted one by one."""
    from torch.utils.flop_counter import FlopCounterMode
    B, Hq, Hkv, hd = 2, 4, 2, 64
    q = torch.zeros((B, Hq, Sq, hd))
    k = v = torch.zeros((B, Hkv, Skv, hd))
    with FlopCounterMode(display=False) as fc:
        ops.flash_attention(q, k, v, causal)
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    pairs = int((qpos >= kpos).sum()) if causal else Sq * Skv
    assert kfa.visible_pairs(Sq, Skv, causal) == pairs
    assert fc.get_total_flops() == 4 * B * Hq * hd * pairs


def test_meter_counts_the_kernels_storage_not_the_scores():
    """Under the dry run's ``Meter`` on fake CPU tensors, attention at S
    4096 holds its output, not the plain version's (S, S) f32 scores
    (0.27 GB a head here); its bytes are q, k, v read and o written."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    B, Hq, Hkv, S, hd = 1, 4, 2, 4096, 128
    with FakeTensorMode():
        q, k, v = _qkv(B, Hq, Hkv, S, hd, torch.bfloat16)
        meter = PD.Meter([q, k, v])
        with meter:
            ops.flash_attention(q, k, v)
    io_bytes = 2 * hd * B * S * (2 * Hq + 2 * Hkv)
    assert meter.bytes == io_bytes
    assert meter.peak == io_bytes
    assert meter.flops == 4 * B * Hq * hd * S * (S + 1) // 2


@pytest.fixture(scope="module")
def reference_serving():
    out = subprocess.run([sys.executable, "-c", REFERENCE, *SERVE_ARCHS],
                         env=dict(_env(), JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_argument_and_alias_bytes_equal_xla(arch, kind, reference_serving):
    """Exactly XLA's (660,480 and 0 for qwen2.5-3b's prefill; 725,516 and
    65,536 for its decode); the parts are what ``specs`` gives."""
    shape = PB.ShapeConfig(kind + "_small", 64, 4, kind)
    new_mesh = functools.partial(make_mesh, ("data", "model"), (2, 2))
    rec = PD.run_cell(arch, shape, "mesh_2x2", new_mesh, "cpu", smoke=True)
    mem = rec["memory"]
    assert [mem["argument_bytes"], mem["alias_bytes"]] == \
        reference_serving[f"{arch} {kind}"]
    mesh = PAPI.Mesh(("data", "model"), (2, 2))
    cfg = preg.get_config(arch).smoke_model()
    params, pspec, _, _ = PS.model_state_specs(cfg, mesh)
    local = sum(int(torch.Size(PS.local_shape(t.shape, pspec[n], mesh))
                    .numel()) * t.element_size() for n, t in params.items())
    if kind == "prefill":
        assert mem["alias_bytes"] == 0
        assert mem["argument_bytes"] == local + 2 * 64 * 4   # 2 rows int32
    else:
        (_, _, caches), (_, _, cspec) = PS.decode_specs(cfg, shape, mesh)
        cache = sum(int(torch.Size(PS.local_shape(t.shape, cspec[n], mesh))
                        .numel()) * t.element_size()
                    for n, t in caches.items())
        assert mem["alias_bytes"] == cache
        assert mem["argument_bytes"] == local + 2 * 4 + 4 + cache
    assert rec["collectives"] and rec["flops_per_dev"] > 0
    assert rec["flash_launches"] == 0
    assert mem["peak_live_bytes"] > mem["argument_bytes"]


def _cli(*argv, timeout=400):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--device", "cpu"], env=_env(), capture_output=True, text=True,
        timeout=timeout)


def test_cli_decode_cell_feeds_from_dryrun(tmp_path):
    """qwen2.5-3b x decode_32k x single_pod_16x16: the reference's keys,
    chips 256, the decode's tokens (B a step) in ``model_flops``; both
    packages' ``from_dryrun`` read its collectives."""
    from repro.core import demand as JD
    from repro_torch.core import demand as PDM
    from repro_torch.launch import hlo_analysis as PH
    out = _cli("--arch", "qwen2.5-3b", "--shape", "decode_32k", "--mesh",
               "single", "--outdir", str(tmp_path))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    f = tmp_path / "qwen2.5-3b__decode_32k__single_pod_16x16.json"
    assert os.listdir(tmp_path) == [f.name]
    rec = json.loads(f.read_text())
    for key in ("arch", "shape", "mesh", "opts", "chips", "kind",
                "flops_per_dev", "bytes_per_dev", "collectives",
                "wire_bytes_per_dev", "collective_operand_bytes_per_dev",
                "memory", "params", "active_params", "model_flops",
                "terms", "useful_flop_ratio"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["kind"] == "decode"
    assert rec["flash_launches"] == 0
    assert rec["model_flops"] == PH.model_flops(rec["active_params"], 128,
                                                "decode")
    mem = rec["memory"]
    assert 0 < mem["alias_bytes"] < mem["argument_bytes"] \
        < mem["peak_live_bytes"]
    assert set(rec["collectives"]) == {"all-gather", "all-reduce"}
    spec = (4, 4, 8)
    want = PDM.from_mix(PDM.Pod(spec), {
        k: v["wire_bytes"] for k, v in rec["collectives"].items()})
    for fn in (PDM.from_dryrun, JD.from_dryrun):
        got = fn(spec, "qwen2.5-3b", "decode_32k",
                 dryrun_dir=str(tmp_path))
        assert (got.w_same_cube, got.w_ring, got.w_uniform) == \
            (want.w_same_cube, want.w_ring, want.w_uniform)


@pytest.mark.parametrize("argv, lines, files", [
    (("--arch", "mamba2-2.7b", "--shape", "decode_32k", "--mesh", "single"),
     ["=== mamba2-2.7b x decode_32k x single_pod_16x16"],
     ["mamba2-2.7b__decode_32k__single_pod_16x16.json"]),
    (("--arch", "qwen2.5-3b", "--shape", "long_500k"),
     ["SKIP qwen2.5-3b x long_500k: "
      + preg.get_config("qwen2.5-3b").notes], [])])
def test_cli_skips_write_nothing(argv, lines, files, tmp_path):
    """A shape not in the arch's ``shapes`` prints the reference's SKIP
    line and writes nothing; a serving cell of the SSM family, which the
    sharded step once left out with a SKIP line, runs and writes its
    file."""
    out = _cli(*argv, "--outdir", str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert [ln for ln in out.stdout.splitlines()
            if ln.startswith(("SKIP", "==="))] == lines
    assert "FAIL" not in out.stdout
    assert sorted(os.listdir(tmp_path)) == files


def test_shape_all_runs_each_archs_shapes():
    """Every arch's cells under ``--shape all``, as the reference's CLI
    walks each arch's ``shapes``: all 32 (arch, shape) cells of the
    registry, every family at each of its shapes (long_500k for
    mamba2-2.7b and jamba-v0.1-52b), 64 files on the two meshes, and no
    SKIP line."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        cells = list(PD._arch_shapes(preg.list_archs(), "all", None))
    want = [(a, s) for a in preg.list_archs()
            for s in preg.get_config(a).shapes]
    assert [(a, s.name) for a, s in cells] == want
    assert len(want) == 7 * 3 + 3 * 3 + 2
    assert len(want) * len(PD.MESH_NAMES) == 64
    assert {a for a, s in want if s == "long_500k"} == {"mamba2-2.7b",
                                                       "jamba-v0.1-52b"}
    assert buf.getvalue() == ""
