"""The port's dry run (``launch/{hlo_analysis, specs, mesh, dryrun}``)
against the reference's.

- ``model_flops``, ``roofline_terms`` (the reference's TPU constants
  passed in) and ``collective_stats`` on HLO lines (those of
  ``test_system.py``'s parser test and one of each other kind) equal the
  reference's exactly; ``collective_stats_from_log`` on the same
  collectives as records equals ``collective_stats``.
- ``make_production_mesh``'s names and sizes, and ``specs``' shapes,
  dtypes and specs at ``train_4k`` and ``decode_32k`` of every arch the
  sharded step covers, on both production meshes, equal the
  reference's. Specs are compared as ``test_torch_parallel.py`` compares
  them: the reference's ``NamedSharding`` patched to return its spec, a
  described mesh, a stacked leaf's spec without its leading None once a
  layer, a cache leaf on its trailing dimensions.
- At the ``smoke_model()`` of qwen2.5-3b, deepseek-moe-16b, mamba2-2.7b,
  jamba-v0.1-52b and seamless-m4t-medium on a (2, 2) ("data", "model")
  mesh and a batch of 4 x 64, the port's ``argument_bytes`` and
  ``alias_bytes`` (the sharded step's local tensors, under a fake group
  of 4 ranks) equal XLA's memory analysis of the reference's
  ``build_lowered`` exactly. The reference runs in a subprocess with 512
  forced host devices (``repro.launch.dryrun`` sets them as it is
  imported), which also reports its production meshes.
- One production cell (qwen2.5-3b x train_4k x single_pod_16x16, ~30 s
  on a CPU) through the CLI under the fake group of 256 ranks: its
  JSON holds the reference's keys, and ``workload_demand`` of the port
  and ``from_dryrun`` of both packages read it. mamba2-2.7b x long_500k
  (a decode of one row, the sharded step's B = 1 layout) runs and
  writes its file; a cell whose shape is not in the arch's ``shapes``
  (qwen2.5-3b x long_500k) prints the reference's SKIP line and writes
  nothing. The serving cells run (``test_torch_dryrun_serve.py``,
  ``test_torch_dryrun_serve_families.py``).
- The SSM, hybrid and encoder-decoder archs' production cells at
  ``train_4k`` and ``decode_32k`` through the CLI (six processes at
  once, 25-45 s each at train_4k on a CPU): each writes its file, which
  ``from_dryrun`` of both packages reads at train_4k.
"""
import functools
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as JB, registry as jreg
from repro.launch import hlo_analysis as JH, specs as JS
from repro.parallel import sharding as JSH
from repro_torch import convert
from repro_torch.configs import base as PB, registry as preg
from repro_torch.launch import dryrun as PD, hlo_analysis as PH, \
    specs as PS
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.parallel import api as PAPI

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SCOPE = ["qwen2.5-3b", "gemma-7b", "stablelm-12b", "qwen1.5-32b",
         "internvl2-2b", "deepseek-moe-16b", "phi3.5-moe-42b-a6.6b",
         "mamba2-2.7b", "jamba-v0.1-52b", "seamless-m4t-medium"]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
# the parser test's lines (test_system.py) and one line of each other kind
HLO = (
    "%all-reduce = f32[32,256]{1,0} all-reduce(%dot), channel_id=1, "
    "replica_groups=[8,16]<=[8,16]T(1,0), use_global_device_ids=true\n"
    "%ag = bf16[64,64]{1,0} all-gather(%p), channel_id=2, "
    "replica_groups={{0,1,2,3}}, dimensions={0}\n"
    "ROOT %fusion = f32[2]{0} fusion(%all-reduce), kind=kLoop\n"
    "%rs = bf16[16,128]{1,0} reduce-scatter(%x), channel_id=3, "
    "replica_groups=[16,16]<=[256], dimensions={0}\n"
    "%a2a = (bf16[4,8]{1,0}, bf16[4,8]{1,0}) all-to-all(%y, %z), "
    "replica_groups={{0,1}}\n"
    "%cp = s32[7]{0} collective-permute(%w), "
    "source_target_pairs={{0,1},{1,0}}\n"
    "%ags = (f32[8]{0}, f32[64]{0}) all-gather-start(%v), "
    "replica_groups=[2,8]<=[16], dimensions={0}\n"
    "%ar2 = u8[3,5]{1,0} all-reduce(%q), replica_groups={}\n")
# the same collectives as records: (kind, result bytes, group size)
RECORDS = [("all-reduce", 32 * 256 * 4, 16), ("all-gather", 64 * 64 * 2, 4),
           ("reduce-scatter", 16 * 128 * 2, 16), ("all-to-all", 4 * 8 * 2, 2),
           ("collective-permute", 7 * 4, 1), ("all-gather", 64 * 4, 8),
           ("all-reduce", 15, 1)]
REFERENCE = """
import json, sys
import repro.launch.dryrun as D
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs.base import ShapeConfig
from repro.configs.registry import get_config
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
shape = ShapeConfig("train_small", 64, 4, "train")
out = {}
for arch in sys.argv[1:]:
    lowered, _ = D.build_lowered(get_config(arch).smoke_model(), shape, mesh)
    compiled = lowered.compile()
    ma = compiled.memory_analysis()
    out[arch] = [int(ma.argument_size_in_bytes), int(ma.alias_size_in_bytes),
                 D.analyze(compiled)["collectives"]]
out["meshes"] = [[list(m.axis_names), list(m.devices.shape)] for m in
                 (D.make_production_mesh(multi_pod=False),
                  D.make_production_mesh(multi_pod=True))]
print(json.dumps(out))
"""
SMOKE_ARCHS = ("qwen2.5-3b", "deepseek-moe-16b", "mamba2-2.7b",
               "jamba-v0.1-52b", "seamless-m4t-medium")
# the families that joined the sharded step after the dense and MoE LMs
FAMILY_ARCHS = ("mamba2-2.7b", "jamba-v0.1-52b", "seamless-m4t-medium")


def described(names, shape):
    """The reference's view of a mesh: names and an empty device array."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, object))


@pytest.fixture
def spec_only(monkeypatch):
    """The reference's ``NamedSharding`` returns its spec, in
    ``parallel.sharding`` and ``launch.specs``."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([SRC] + sys.path),
                OMP_NUM_THREADS="1")


def test_model_flops_and_roofline_terms_match_reference():
    for n, tokens, kind in [(3_085_938_688, 1_048_576, "train"),
                            (2_818_572_288, 32768 * 32, "prefill"),
                            (1, 1, "decode")]:
        assert PH.model_flops(n, tokens, kind) == \
            JH.model_flops(n, tokens, kind)
    rates = dict(peak_flops=JH.PEAK_FLOPS, hbm_bytes_per_s=JH.HBM_BW,
                 link_bytes_per_s=JH.LINK_BW, links_per_chip=JH.LINKS_PER_CHIP)
    for args in [(1e12, 1e11, 1e9, 256), (5e14, 1e9, 1e12, 512),
                 (0.0, 0.0, 0.0, 4), (3e13, 7e12, 0.0, 256)]:
        assert PH.roofline_terms(*args, **rates) == JH.roofline_terms(*args)


def test_collective_stats_match_reference():
    want = JH.collective_stats(HLO)
    assert PH.collective_stats(HLO) == want
    assert set(want) == {"all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute"}
    assert PH.collective_stats_from_log(RECORDS) == want
    with pytest.raises(ValueError):
        PH.wire("broadcast", 8, 2)


def _torch_dtype(jdtype) -> torch.dtype:
    return getattr(torch, str(np.dtype(jdtype)) if str(jdtype) != "bfloat16"
                   else "bfloat16")


def _object(value):
    a = np.empty((), object)
    a[()] = value
    return a


def _reference_by_port_name(cfg, jshapes, jspecs):
    """(shape, dtype, spec) of every reference leaf under the port's
    names: a stacked leaf's per layer, without its leading axis and its
    leading None."""
    def f(path, leaf, spec):
        spec = tuple(spec)
        if path[0].key not in ("blocks", "enc_blocks", "dec_blocks"):
            return _object((tuple(leaf.shape), leaf.dtype, spec))
        assert not spec or spec[0] is None, (path, spec)
        out = np.empty(leaf.shape[0], object)
        for j in range(len(out)):
            out[j] = (tuple(leaf.shape[1:]), leaf.dtype, spec[1:])
        return out
    tree = jax.tree_util.tree_map_with_path(f, jshapes, jspecs)
    return {n: v.item() if isinstance(v, np.ndarray) else v
            for n, v in convert._state(cfg, tree).items()}


def _check(got, gspec, want):
    assert set(got) == set(want)
    for n, t in got.items():
        shape, dtype, spec = want[n]
        assert tuple(t.shape) == shape, n
        assert t.dtype == _torch_dtype(dtype), n
        assert gspec[n] == spec, n
        assert t.device.type == "meta"


def _local_bytes(tensors, specs, mesh) -> int:
    """The bytes one device holds of ``tensors`` under ``specs``."""
    return sum(int(np.prod(PS.local_shape(t.shape, specs[n], mesh)))
               * t.element_size() for n, t in tensors.items())


def _tail(spec, ndim, k):
    full = tuple(spec) + (None,) * (ndim - len(spec))
    return full[ndim - k:], all(e is None for e in full[:ndim - k])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SCOPE)
def test_specs_match_reference(arch, mesh, spec_only):
    """Batch, parameter, AdamW and decode specs at full width."""
    names, shape = MESHES[mesh]
    jmesh, pmesh = described(names, shape), PAPI.Mesh(names, shape)
    jcfg, pcfg = jreg.get_config(arch).model, preg.get_config(arch).model
    for s in ("train_4k", "decode_32k"):
        jshape, pshape = JB.SHAPES[s], PB.SHAPES[s]
        if jshape.kind == "train":
            jb, jbs = JS.batch_specs(jcfg, jshape, jmesh)
            pb, pbs = PS.batch_specs(pcfg, pshape, pmesh)
            _check(pb, pbs, {k: (tuple(v.shape), v.dtype, tuple(jbs[k]))
                             for k, v in jb.items()})
            continue
        (tok, pos, caches), (ts, ps, cs) = JS.decode_specs(jcfg, jshape,
                                                           jmesh)
        (ptok, ppos, pcaches), (pts, pps, pcs) = PS.decode_specs(
            pcfg, pshape, pmesh)
        _check({"token": ptok, "pos": ppos}, {"token": pts, "pos": pps},
               {"token": (tuple(tok.shape), tok.dtype, tuple(ts)),
                "pos": (tuple(pos.shape), pos.dtype, tuple(ps))})
        ref = {}
        for (path, spec), leaf in zip(
                jax.tree_util.tree_flatten_with_path(cs)[0],
                jax.tree_util.tree_leaves(caches)):
            ref.setdefault(path[-1].key, []).append(
                (tuple(spec), leaf.shape, leaf.dtype))
        assert set(ref) == set(pcaches)
        for name, t in pcaches.items():
            k = 3 if name == "conv" else 4
            tail, lead_none = _tail(pcs[name], t.ndim, k)
            assert lead_none and t.device.type == "meta"
            assert t.shape[0] == sum(j[1][0] if len(j[1]) > k else 1
                                     for j in ref[name])
            for spec, jshape_, jdtype in ref[name]:
                assert jshape_[-k:] == tuple(t.shape[-k:]), name
                assert t.dtype == _torch_dtype(jdtype)
                assert _tail(spec, len(jshape_), k) == (tail, True), name
    jp, jps, jo, jos = JS.model_state_specs(jcfg, jmesh, with_opt=True)
    pp, pps, po, pos_ = PS.model_state_specs(pcfg, pmesh)
    _check(pp, pps, _reference_by_port_name(jcfg, jp, jps))
    for key in ("m", "v"):
        _check(po[key], pos_[key],
               _reference_by_port_name(jcfg, jo[key], jos[key]))
    assert (tuple(po["step"].shape), po["step"].dtype, pos_["step"]) == \
        (tuple(jo["step"].shape), torch.int32, tuple(jos["step"]))
    # one device's bytes of the parameters: the same on both sides
    want = sum(np.prod(PS.local_shape(s, sp, pmesh)) * np.dtype(d).itemsize
               for s, d, sp in _reference_by_port_name(jcfg, jp, jps).values())
    assert _local_bytes(pp, pps, pmesh) == want


@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's XLA memory analysis of the smoke archs on (2, 2)
    and its production meshes, from a subprocess with forced devices."""
    out = subprocess.run([sys.executable, "-c", REFERENCE, *SMOKE_ARCHS],
                         env=dict(_env(), JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_production_mesh_matches_reference(reference_dryrun):
    """Names and sizes; a description with no DeviceMesh outside a
    group of its size."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    got = [make_production_mesh(), make_production_mesh(multi_pod=True)]
    assert [[list(m.axis_names), list(m.shape)] for m in got] == \
        reference_dryrun["meshes"]
    assert all(m.device_mesh is None for m in got)
    assert [m.size for m in got] == [256, 512]


@pytest.fixture(scope="module")
def port_smoke():
    """The port's dry-run record of each smoke arch on (2, 2), 4 x 64."""
    shape = PB.ShapeConfig("train_small", 64, 4, "train")
    new_mesh = functools.partial(make_mesh, ("data", "model"), (2, 2))
    return {arch: PD.run_cell(arch, shape, "mesh_2x2", new_mesh, "cpu",
                              smoke=True)
            for arch in SMOKE_ARCHS}


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_argument_and_alias_bytes_equal_xla(arch, reference_dryrun,
                                            port_smoke):
    """The sharded step's state and batch on rank 0 of a fake (2, 2)
    group: exactly XLA's argument and alias bytes (3,300,868 and
    3,299,844 for qwen2.5-3b; 4,197,892 and 4,196,868 for
    deepseek-moe-16b); the state is also what ``specs`` gives."""
    rec = port_smoke[arch]
    mem = rec["memory"]
    assert [mem["argument_bytes"], mem["alias_bytes"]] == \
        reference_dryrun[arch][:2]
    mesh = PAPI.Mesh(("data", "model"), (2, 2))
    cfg = preg.get_config(arch).smoke_model()
    params, pspec, opt, ospec = PS.model_state_specs(cfg, mesh)
    state = _local_bytes(params, pspec, mesh) + sum(
        _local_bytes(opt[k], ospec[k], mesh) for k in ("m", "v")) + 4
    assert mem["alias_bytes"] == state
    # tokens and labels, int32, two rows of 64 a data shard; an
    # encoder-decoder's frames, bf16 rows of d_model
    frames = (4 // 2) * 64 * cfg.d_model * 2 if cfg.family == "encdec" \
        else 0
    assert mem["argument_bytes"] - state == 2 * (4 // 2) * 64 * 4 + frames
    assert rec["collectives"] and rec["flops_per_dev"] > 0
    assert mem["peak_live_bytes"] > mem["argument_bytes"]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_collective_mix_beside_the_reference(arch, reference_dryrun,
                                             port_smoke):
    """The two programs shard alike but issue other collectives: GSPMD
    chose all-gathers, all-reduces, collective-permutes and all-to-alls
    (even for the dense arch); the port's step issues FSDP's all-gathers
    and reduce-scatters and the model group's all-reduces, and no
    all-to-all (``layers.moe_ffn_ep``'s partial combine). Printed side by
    side (``-s``): count and wire bytes a device by kind."""
    ref = reference_dryrun[arch][2]
    port = port_smoke[arch]["collectives"]
    for name, mix in (("reference XLA", ref), ("port", port)):
        print(f"{arch} (2, 2) 4 x 64, {name}: " + ", ".join(
            f"{k} {v['count']} / {v['wire_bytes']:.0f} B"
            for k, v in sorted(mix.items())))
    assert {"all-gather", "all-reduce"} <= set(ref)
    assert set(port) == {"all-gather", "all-reduce", "reduce-scatter"}


def test_cli_production_cell_feeds_workload_demand(tmp_path):
    """qwen2.5-3b x train_4k x single_pod_16x16 under a fake group of 256
    ranks: the reference's file name and keys (less ``extrapolated``);
    ``workload_demand`` of the port and ``from_dryrun`` of both packages
    read its collectives. A cell that does not run: a SKIP line, nothing
    written."""
    from repro.core import demand as JD
    from repro_torch.core import demand as PDM, workload as PW
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "train_4k", "--mesh", "single",
         "--device", "cpu", "--outdir", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    f = tmp_path / "qwen2.5-3b__train_4k__single_pod_16x16.json"
    assert os.listdir(tmp_path) == [f.name]
    rec = json.loads(f.read_text())
    for key in ("arch", "shape", "mesh", "opts", "chips", "kind",
                "flops_per_dev", "bytes_per_dev", "collectives",
                "wire_bytes_per_dev", "collective_operand_bytes_per_dev",
                "memory", "params", "active_params", "model_flops",
                "terms", "useful_flop_ratio"):
        assert key in rec, key
    assert "extrapolated" not in rec and rec["chips"] == 256
    mem = rec["memory"]
    assert mem["alias_bytes"] < mem["argument_bytes"] < mem["peak_live_bytes"]
    assert isinstance(mem["fits_h100_80g"], bool)
    assert rec["collectives"]["reduce-scatter"]["count"] > 0
    assert rec["wire_bytes_per_dev"] == sum(
        v["wire_bytes"] for v in rec["collectives"].values())
    assert rec["terms"] == PH.roofline_terms(
        rec["flops_per_dev"], rec["bytes_per_dev"],
        rec["wire_bytes_per_dev"], 256, **rec["rates"])
    wires = {k: v["wire_bytes"] for k, v in rec["collectives"].items()}
    spec = (4, 4, 8)
    want = PDM.from_mix(PDM.Pod(spec), wires)
    for got in (PW.workload_demand(spec, "qwen2.5-3b",
                                   dryrun_dir=str(tmp_path)),
                PDM.from_dryrun(spec, "qwen2.5-3b", "train_4k",
                                dryrun_dir=str(tmp_path)),
                JD.from_dryrun(spec, "qwen2.5-3b", "train_4k",
                               dryrun_dir=str(tmp_path))):
        assert (got.w_same_cube, got.w_ring, got.w_uniform) == \
            (want.w_same_cube, want.w_ring, want.w_uniform)
    assert (want.w_same_cube, want.w_ring) != (0.0, 0.0)
    for argv, line, files in [
            (["--arch", "mamba2-2.7b", "--shape", "long_500k", "--mesh",
              "single"], "=== mamba2-2.7b x long_500k x single_pod_16x16",
             ["mamba2-2.7b__long_500k__single_pod_16x16.json"]),
            (["--arch", "qwen2.5-3b", "--shape", "long_500k"],
             "SKIP qwen2.5-3b x long_500k", [])]:
        other = tmp_path / argv[1]
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--device", "cpu", "--outdir", str(other)],
            env=_env(), capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and out.stdout.startswith(line), \
            out.stdout + out.stderr[-2000:]
        assert "FAIL" not in out.stdout
        assert sorted(os.listdir(other)) == files


def test_cli_runs_the_other_families_at_train_4k(tmp_path):
    """mamba2-2.7b, jamba-v0.1-52b and seamless-m4t-medium at train_4k on
    single_pod_16x16, each CLI in a process of its own, all at once: no
    SKIP, the reference's file written, and ``from_dryrun`` of both
    packages reads it; at decode_32k (started beside them) each runs
    too and writes its file."""
    from repro.core import demand as JD
    from repro_torch.core import demand as PDM

    def cli(arch, shape, outdir):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--device", "cpu",
             "--outdir", str(outdir)], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    serve = tmp_path / "serve"
    procs = {a: cli(a, "train_4k", tmp_path) for a in FAMILY_ARCHS}
    decodes = {a: cli(a, "decode_32k", serve) for a in FAMILY_ARCHS}
    for arch, p in procs.items():
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, out[-4000:]
        assert out.startswith(f"=== {arch} x train_4k x single_pod_16x16")
        assert "SKIP" not in out and "FAIL" not in out, out[-4000:]
        rec = json.loads((tmp_path / f"{arch}__train_4k__single_pod_16x16"
                          ".json").read_text())
        assert rec["chips"] == 256 and rec["collectives"]
        spec = (4, 4, 8)
        got = [f(spec, arch, "train_4k", dryrun_dir=str(tmp_path))
               for f in (PDM.from_dryrun, JD.from_dryrun)]
        want = PDM.from_mix(PDM.Pod(spec), {
            k: v["wire_bytes"] for k, v in rec["collectives"].items()})
        for d in got:
            assert (d.w_same_cube, d.w_ring, d.w_uniform) == \
                (want.w_same_cube, want.w_ring, want.w_uniform)
        p = decodes[arch]
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0 and out.startswith(
            f"=== {arch} x decode_32k x single_pod_16x16"), out[-2000:]
        assert "SKIP" not in out and "FAIL" not in out, out[-4000:]
    assert sorted(f.name for f in tmp_path.glob("*.json")) == sorted(
        f"{a}__train_4k__single_pod_16x16.json" for a in FAMILY_ARCHS)
    assert sorted(os.listdir(serve)) == sorted(
        f"{a}__decode_32k__single_pod_16x16.json" for a in FAMILY_ARCHS)


def test_dryrun_needs_cuda_by_default():
    """The entry point runs on CUDA unless asked for the CPU: here it
    raises before it traces anything."""
    with pytest.raises(RuntimeError, match="CUDA"):
        PD.main(["--arch", "qwen2.5-3b"])
