"""The sharded serving step of the SSM, hybrid and encoder-decoder
families (``parallel.spmd``: ``ShardedLM.prefill`` / ``decode_step`` with
Mamba mixers, ``ShardedEncDec.prefill`` / ``decode_step``) on the CPU,
over ``torch_spmd_workers.FAMILY_CASES``: mamba2-2.7b, jamba-v0.1-52b's
one super-block (attention, Mamba and MoE layers) and
seamless-m4t-medium, also at a vocabulary of 511 that does not divide
over "model".

The method and bounds of ``test_torch_spmd_serve.py`` (its helpers run
here): four gloo ranks on a ("data", "model") (2, 2) mesh, from the
reference's seed-0 weights, a prompt of 32 tokens (an encoder-decoder's
frames beside it) prefilled into caches 3 positions longer, then 3
decode steps of the reference's own greedy tokens, so that both sides
follow one path; against one process (``model.prefill_fn`` /
``decode_fn`` under a described (2, 2) mesh) within the arch's
whole-model tolerance (``torch_parity.MODEL_TOL``), and against the
reference's prefill and decode jitted on the same mesh within
``REF_TOL`` (rtol 0.06, atol 0.15); logits of each step, each row's
greedy token by the near-tie rule, and every cache after the prefill
and after the last step: ``conv`` and ``ssm`` of the Mamba layers,
``k`` and ``v``, and an encoder-decoder's ``ek`` and ``ev``, which
every rank holds whole and bit for bit alike. jamba's MoE is compared
on the runs that choose the reference's experts, after its first
routing difference is checked to be a near tie. Besides:
- every rank's collectives of the prefill and of each decode step
  equal those of the fake run the dry run traces for rank 0;
- a B = 1 decode (``SEQ_CASES``: jamba, and jamba with one kv head,
  whose cache's head_dim columns lie over "model" as the sequence lies
  over "data"): the plain prefill of one prompt row in one process into
  a cache of 64 positions, cut to each rank's block under
  ``cache_specs``, then 3 greedy steps through ``decode_step``, against
  the same steps in one process within the arch's tolerance; the row is
  whole on every rank, so every rank's logits and caches of a block are
  equal;
- at (1, 1) on one rank the three archs are the plain prefill and
  decode bit for bit, caches included, with no collective.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_models as TM
import test_torch_spmd as TS
import test_torch_spmd_serve as SS
import torch_dp_workers as DW
import torch_parity as TP
import torch_spmd_workers as W
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as PD
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as PM
from repro_torch.parallel import api, spmd
from repro_torch.parallel.sharding import cache_specs
from test_torch_spmd import _one_torch_thread  # noqa: F401 (autouse)

MESH = TS.MESH
CACHE_LEN = W.S + W.FAMILY_STEPS
REFERENCE = SS.REFERENCE.split("def caches(c):")[0] + """
def layer_cache(jcfg, c, i):
    # layer i's cache in the reference's tree
    if jcfg.family == "hybrid":
        P = jcfg.hybrid_period
        return jax.tree.map(lambda a: a[i // P], c["blocks"][f"sub{i % P}"])
    if i < jcfg.first_k_dense:
        return c["head_blocks"][i]
    return jax.tree.map(lambda a: a[i - jcfg.first_k_dense], c["blocks"])


def caches(jcfg, pcfg, c):
    # the reference's cache tree as the port's stacked caches (float32)
    if "dec_blocks" in c:
        return {n: torch.as_tensor(np.asarray(c["dec_blocks"][n]).astype(
            np.float32)) for n in ("k", "v", "ek", "ev")}
    per = {}
    for i, (mixer, _) in enumerate(plm.layer_kinds(pcfg)):
        layer = layer_cache(jcfg, c, i)
        for n in ("k", "v") if mixer == "attn" else ("conv", "ssm"):
            per.setdefault(n, []).append(
                np.asarray(layer[n]).astype(np.float32))
    return {n: torch.as_tensor(np.stack(v)) for n, v in per.items()}


def logits(x):
    return torch.as_tensor(np.asarray(x).astype(np.float32))


from repro_torch.models import lm as plm
cache_len = W.S + W.FAMILY_STEPS
for case in sys.argv[2:]:
    jcfg, pcfg = W.smoke(case, jreg), W.smoke(case)
    routes.clear()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    torch.save({n: p.detach().clone() for n, p in model.named_parameters()},
               os.path.join(out, case + ".init.pt"))
    prompt, _ = W.serve_inputs(case)
    with mesh_context(mesh):
        _, pspec, _, _ = model_state_specs(jcfg, mesh, with_opt=False)
        _, bspec = batch_specs(jcfg, ShapeConfig("p", W.S, W.B, "prefill"),
                               mesh)
        (_, _, _), (tspec, posspec, cspec) = decode_specs(
            jcfg, ShapeConfig("d", cache_len, W.B, "decode"), mesh)

        def prefill(p, b):
            return JM.prefill_fn(jcfg, p, b, cache_len=cache_len)
        lspec = NamedSharding(mesh, filter_spec(
            (("pod", "data"), None, "model"), mesh, (W.B, 1, jcfg.vocab)))
        pre = jax.jit(prefill, in_shardings=(pspec, bspec),
                      out_shardings=(lspec, cspec))
        dec = jax.jit(make_serve_step(jcfg),
                      in_shardings=(pspec, tspec, posspec, cspec),
                      out_shardings=(lspec, cspec), donate_argnums=(3,))
        params = jax.device_put(params, pspec)
        batch = {k: np.asarray(v) for k, v in prompt.items()}
        lg, c = pre(params, batch)
        rec = {"logits": [logits(lg)],
               "prefill_caches": caches(jcfg, pcfg, c)}
        tokens = []
        for i in range(W.FAMILY_STEPS):
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            tokens.append(np.asarray(tok))
            lg, c = dec(params, tok, jnp.int32(W.S + i), c)
            rec["logits"].append(logits(lg))
        rec["caches"] = caches(jcfg, pcfg, c)
        rec["tokens"] = torch.as_tensor(np.concatenate(tokens, 1).astype(
            np.int64))
    jax.effects_barrier()
    rec["routes"] = list(routes)
    torch.save(rec, os.path.join(out, case + ".serve.pt"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The directory of each case's seed-0 weights and the reference's
    serving run (``<case>.serve.pt``: its greedy tokens under
    "tokens")."""
    tmp = tmp_path_factory.mktemp("spmd_serve_families_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([TS.SRC, TS.TESTS] + sys.path))
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp),
                          *W.FAMILY_CASES], env=env, capture_output=True,
                         text=True, timeout=TS.REFERENCE_TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return str(tmp)


def _want(reference, case):
    return torch.load(os.path.join(reference, f"{case}.serve.pt"))


def _tol(case):
    """The arch's whole-model tolerance (``test_torch_spmd_serve._tol``)."""
    arch = {**W.CASES, **W.SERVE_CASES}[case][0]
    return TP.MODEL_TOL.get(arch, (TM.BF16_MODEL, TM.BF16_MODEL))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, reference):
    follows = {"init_dir": reference, "tokens": {}}
    for case in W.FAMILY_CASES:
        want = _want(reference, case)
        follows["tokens"][case] = want["tokens"]
        if W.smoke(case).n_experts:
            follows[case] = [[e for e, _ in shards]
                             for shards in SS._by_shard(want["routes"])]
    tmp = tmp_path_factory.mktemp("spmd_serve_families4")
    return DW.run(W.serve_world, 4, tmp, MESH, follows, W.FAMILY_CASES,
                  timeout=TS.SPAWN_TIMEOUT)


def _whole_cache(cfg, B, cache_len):
    """The whole cache's shapes (on ``meta``) and specs on the (2, 2)
    mesh."""
    whole = PM.empty_cache(cfg, B, cache_len, S_enc=W.S, device="meta")
    return whole, cache_specs(whole, api.Mesh(W.NAMES, MESH))


def gathered(case, ranks, B=W.B, cache_len=CACHE_LEN, steps=W.FAMILY_STEPS):
    """Each step's whole logits and every whole cache after the prefill
    (where the ranks ran one) and after the last step, from the ranks'
    blocks (``test_torch_spmd_serve._assemble``: ranks that hold a block
    alike hold it bit for bit)."""
    cfg = W.smoke(case)
    mesh = api.Mesh(W.NAMES, MESH)
    shape = (B, 1, cfg.vocab)
    lspec = api.filter_spec((("pod", "data"), None, "model"), mesh, shape)
    out = {"logits": [SS._assemble([r["logits"][i] for r in ranks], lspec,
                                   shape, ranks)
                      for i in range(len(ranks[0]["logits"]))]}
    assert len(out["logits"]) in (steps, steps + 1)
    whole, specs = _whole_cache(cfg, B, cache_len)
    for key in ("prefill_caches", "caches"):
        if key in ranks[0]:
            out[key] = {n: SS._assemble([r[key][n] for r in ranks],
                                        specs[n], t.shape, ranks)
                        for n, t in whole.items()}
    return out


def _check(case, got, want, label, tol):
    errs = [SS._close(g, w, f"{case} {label} logits {i}", tol)
            for i, (g, w) in enumerate(zip(got["logits"], want["logits"]))]
    flips = sum(SS._greedy_checked(g, w, tol[1])
                for g, w in zip(got["logits"], want["logits"]))
    names = []
    for key in ("prefill_caches", "caches"):
        if key not in got:
            continue
        assert set(got[key]) == set(want[key]), (key, set(want[key]))
        for n in want[key]:
            names.append(n)
            errs.append(SS._close(got[key][n], want[key][n],
                                  f"{case} {label} {key} {n}", tol))
    print(f"{case} against {label}: max err {max(errs):.3g} over logits "
          f"and {sorted(set(names))}, greedy flips {flips}")


@pytest.mark.parametrize("case", list(W.FAMILY_CASES))
def test_four_ranks_match_one_process(case, four_ranks, reference):
    want = _want(reference, case)
    ranks = [r[case] for r in four_ranks]
    one = W.serve_one_process(case, MESH, reference, tokens=want["tokens"])
    ranks, first = SS._compared(case, ranks,
                                SS._one_process_calls(case, one["routes"]))
    if W.smoke(case).n_experts:
        calls = [[e for e, _ in s] for s in SS._by_shard(want["routes"])]
        one = W.serve_one_process(
            case, MESH, reference, tokens=want["tokens"],
            follow=SS._follow_one_process(case, calls))
    print(f"{case}: first routing difference {first}")
    _check(case, gathered(case, ranks), one, "one process", _tol(case))


@pytest.mark.parametrize("case", list(W.FAMILY_CASES))
def test_four_ranks_match_the_reference(case, four_ranks, reference):
    want = _want(reference, case)
    ranks, first = SS._compared(case, [r[case] for r in four_ranks],
                                SS._by_shard(want["routes"]))
    print(f"{case}: first routing difference {first}")
    _check(case, gathered(case, ranks), want, "the reference", SS.REF_TOL)


@pytest.mark.parametrize("case", list(W.FAMILY_CASES))
def test_real_collectives_equal_the_fake_trace(case, four_ranks):
    """The prefill's and each decode step's log, on every rank and in the
    fake run of rank 0."""
    import torch.distributed as dist
    logs = [r[case]["collectives"] for r in four_ranks]
    assert all(log == logs[0] for log in logs)
    assert all(step == logs[0][1] for step in logs[0][1:])
    assert not dist.is_initialized()
    new_mesh = functools.partial(make_mesh, W.NAMES, MESH)
    cfg = W.smoke(case)
    pre = PD.trace_step(cfg, ShapeConfig("p", W.S, W.B, "prefill"),
                        new_mesh, "cpu")
    dec = PD.trace_step(cfg, ShapeConfig("d", CACHE_LEN, W.B, "decode"),
                        new_mesh, "cpu")
    assert pre["log"] == logs[0][0]
    assert dec["log"] == logs[0][1]
    assert pre["flash_launches"] == dec["flash_launches"] == 0
    assert {k for k, _, _ in pre["log"]} <= {"all-gather", "all-reduce"}


@pytest.fixture(scope="module")
def seq_split(tmp_path_factory):
    """The one-process B = 1 runs (``seq_plain``, here with no group) and
    the four ranks' decode from their caches."""
    plains = {c: W.seq_plain(c) for c in W.SEQ_CASES}
    tmp = tmp_path_factory.mktemp("spmd_seq_split4")
    return plains, DW.run(W.serve_seq_split, 4, tmp, MESH, plains,
                          timeout=TS.SPAWN_TIMEOUT)


@pytest.mark.parametrize("case", list(W.SEQ_CASES))
def test_sequence_split_decode_matches_one_process(case, seq_split):
    """The kv cache's sequence over "data" (32 positions a rank; the
    decode's writes land on data rank 1), the row whole on every rank:
    the specs say so, every routing call chose the one process's
    experts or differs at a near tie (the run that chose them is then
    compared), and each step's logits and the caches after the last
    step are within the arch's tolerance."""
    plain, ranks = seq_split[0][case], [r[case] for r in seq_split[1]]
    cfg = W.smoke(case)
    specs = _whole_cache(cfg, 1, W.SEQ_LEN)[1]
    assert specs["k"][2] == "data" and specs["conv"][1] is None
    assert "model" in specs["k"][3 if cfg.n_kv_heads % 2 == 0 else 4]
    diff = [(k, [int(e) for e in want[0][0]], r["routes"][k][0].tolist())
            for r in ranks for k, want in enumerate(plain["routes"])
            if not torch.equal(r["routes"][k][0], want[0])]
    for k, _, _ in diff:
        top = plain["routes"][k][1].sort(dim=1, descending=True).values[0]
        assert float(top[cfg.top_k - 1] - top[cfg.top_k]) < TP.NEAR_TIE
    if diff:
        ranks = [r["followed"] for r in ranks]
    print(f"{case}: routing differences {diff}")
    got = gathered(case, ranks, B=1, cache_len=W.SEQ_LEN, steps=W.SEQ_STEPS)
    _check(case, got, {"logits": plain["logits"], "caches": plain["caches"]},
           "one process", _tol(case))


@pytest.mark.parametrize("case", list(W.SEQ_CASES))
def test_sequence_split_collectives_equal_the_fake_trace(case, seq_split):
    """Each B = 1 decode step's log on every rank equals the fake run's
    of a decode at B = 1 against a cache of SEQ_LEN positions: the
    softmax's max, sum and P.V all-reduces over "data" included, no
    sum over the batch groups in the MoE."""
    logs = [r[case]["collectives"] for r in seq_split[1]]
    assert all(log == logs[0] for log in logs)
    assert all(step == logs[0][0] for step in logs[0])
    fake = PD.trace_step(W.smoke(case), ShapeConfig(
        "l", W.SEQ_LEN, 1, "decode"), functools.partial(
        make_mesh, W.NAMES, MESH), "cpu")
    assert fake["log"] == logs[0][0]


def test_world_one_is_the_plain_prefill_and_decode(tmp_path):
    """mamba2-2.7b, jamba-v0.1-52b and seamless-m4t-medium
    (``torch_spmd_workers.FAMILY_ARCHS``) on one gloo rank: the plain
    path's logits and every cache bit for bit, no collective."""
    (res,) = DW.run(W.serve_world_one, 1, tmp_path, W.FAMILY_ARCHS,
                    timeout=TS.SPAWN_TIMEOUT)
    for arch, want in res["plain"].items():
        got = res["sharded"][arch]
        assert len(got["logits"]) == W.SERVE_STEPS + 1
        for g, w in zip(got["logits"], want["logits"]):
            assert torch.equal(g, w), arch
        for key in ("prefill_caches", "caches"):
            assert set(got[key]) == set(want[key])
            for n, t in want[key].items():
                assert got[key][n].dtype == t.dtype, (arch, key, n)
                assert torch.equal(got[key][n], t), (arch, key, n)
        assert got["collectives"] == [[]] * (W.SERVE_STEPS + 1), arch
