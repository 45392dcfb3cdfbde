"""The port's per-data-shard MoE dispatch (``moe_ffn_local``) against the
reference's, on the CPU, under a described mesh of 2 and 4 data shards
held by one process.

The reference reads the mesh only through ``parallel.api.get_mesh``
(``_dp_shards``: ``axis_names`` and ``devices.shape``) and constrains
its buffers with ``wsc``, which needs real devices. So each test that
runs it sets the reference's mesh to a description
(``monkeypatch.setattr(repro.parallel.api, "_MESH", ...)``) and patches
``repro.models.layers.wsc`` to the identity -- and, for a whole model,
``repro.models.lm.wsc`` and ``repro.models.seq2seq.wsc`` -- inside the
test only; ``monkeypatch`` restores both after it. The port takes
``parallel.api.Mesh(("data", "model"), (dp, 1))``.

MoE trees from ``init_moe`` at the smoke widths of the three MoE archs,
carried over by ``convert.module_params_from_jax``; inputs from
``default_rng`` (``test_torch_moe.py``'s helpers). Tolerances, each
with its reason:
- the experts chosen and the kept set, per shard: exact (the router runs
  in f32 on equal bf16 inputs);
- y: ``test_torch_moe.BF16_LAYER`` (2e-2 of the row's largest |y|), the
  combine adding at most top_k bf16 summands in bf16 on both sides, the
  expert GEMMs summing in other orders;
- aux: ``test_torch_moe.AUX_TOL`` (1e-6 absolute, f32 means of equal
  probabilities);
- gradients of the input and of every MoE leaf, per leaf
  ``||g - g_ref|| / ||g_ref||`` under ``LAYER_GRAD_REL`` 2e-2 (one bf16
  layer's, as ``test_torch_train_families.py`` holds ``moe_ffn``);
- a smoke model's loss with ``opt_moe_local_dispatch``: 1e-2 relative
  (the training tests' bf16 forward), after the routing check of
  ``torch_parity`` (the first call routed otherwise differs only at
  near ties of the reference), on the run that follows the reference's
  experts.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as R
from repro.configs import registry as jreg
from repro.data import synthetic as JD
from repro.models import layers as JL, lm as JLM, model as JM, \
    seq2seq as JS2S
from repro.parallel import api as JAPI
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.data import synthetic as PD
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as PL, model as PM
from repro_torch.optim import adamw as PA
from repro_torch.parallel import api as PAPI
from repro_torch.train import loop as PT
from test_torch_moe import AUX_TOL, BF16_LAYER, _layer, _t, _x, row_rel_err

ARCHS = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"]
LAYER_GRAD_REL = 2e-2
LOSS_RTOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _x64_off():
    """Caveat R3: another module may have turned JAX's x64 mode on."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


def _described(dp):
    """The reference's view of a (dp, 1) ("data", "model") mesh."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((dp, 1), object))


def _reference_mesh(monkeypatch, dp, modules=(JL,)):
    monkeypatch.setattr(JAPI, "_MESH", _described(dp))
    for mod in modules:
        monkeypatch.setattr(mod, "wsc", lambda x, *spec: x)


def _port_mesh(dp):
    return PAPI.mesh_context(PAPI.Mesh(("data", "model"), (dp, 1)))


def _reference_local_route(p, x, cfg, dp):
    """The experts chosen (T, K, top-k order) and kept (T, K) by the
    reference's own lines (``layers.py:293-319``), each shard's tokens
    sorted and placed on their own."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    Tl = B * S // dp
    cf = 1.0 if cfg.opt_moe_cf1 else cfg.capacity_factor
    C = max(8, int(Tl * K * cf / E))
    probs = jax.nn.softmax(x.reshape(dp, Tl, D).astype(jnp.float32)
                           @ p["router"], axis=-1)
    _, eidx = jax.lax.top_k(probs, K)
    keep = []
    for g in range(dp):
        fe = eidx[g].reshape(Tl * K)
        order = jnp.argsort(fe)
        se = fe[order]
        pos = jnp.arange(Tl * K) - jnp.searchsorted(se, jnp.arange(E))[se]
        keep.append(jnp.zeros(Tl * K, bool).at[order].set(pos < C))
    return (np.asarray(eidx).reshape(B * S, K),
            np.concatenate([np.asarray(k) for k in keep]).reshape(B * S, K))


def _record_port_routes(monkeypatch, log):
    orig = PL.moe_route

    def rec(p, xf, cfg, C):
        r = orig(p, xf, cfg, C)
        log.append((r, C))
        return r
    monkeypatch.setattr(PL, "moe_route", rec)


def _port_local_route(log, K):
    """The port's shards' experts (T, K, top-k order) and kept (T, K)."""
    eidx, keep = [], []
    for r, _ in log:
        T = r.eidx.shape[0]
        kept = torch.zeros(T * K, dtype=torch.bool)
        kept[torch.argsort(r.eidx.reshape(-1), stable=True)] = r.keep
        eidx.append(r.eidx.numpy())
        keep.append(kept.view(T, K).numpy())
    return np.concatenate(eidx), np.concatenate(keep)


def _cfgs(arch, cf1):
    jcfg, p, pcfg, moe = _layer(arch)
    jcfg = dataclasses.replace(jcfg, opt_moe_cf1=cf1)
    pcfg = dataclasses.replace(pcfg, opt_moe_cf1=cf1)
    return jcfg, p, pcfg, moe


def _check_local(monkeypatch, arch, dp, cf1, B, S, seed, common=0.0):
    jcfg, p, pcfg, moe = _cfgs(arch, cf1)
    x = _x(B, S, jcfg.d_model, seed, common)
    _reference_mesh(monkeypatch, dp)
    y, aux = JL.moe_ffn_local(p, x, jcfg)
    want_eidx, want_keep = _reference_local_route(p, x, jcfg, dp)
    log = []
    _record_port_routes(monkeypatch, log)
    with torch.no_grad(), _port_mesh(dp):
        py, paux = PL.moe_ffn_local(moe, _t(x), pcfg)
    Tl = B * S // dp
    assert [r.eidx.shape[0] for r, _ in log] == [Tl] * dp
    cf = 1.0 if cf1 else jcfg.capacity_factor
    assert {C for _, C in log} == {max(8, int(Tl * jcfg.top_k * cf
                                             / jcfg.n_experts))}
    eidx, keep = _port_local_route(log, pcfg.top_k)
    np.testing.assert_array_equal(eidx, want_eidx)
    np.testing.assert_array_equal(keep, want_keep)
    assert py.dtype == torch.bfloat16 and py.shape == x.shape
    assert row_rel_err(py, y) <= BF16_LAYER
    assert paux.dtype == torch.float32
    assert abs(float(paux) - float(aux)) <= AUX_TOL
    return keep


@pytest.mark.parametrize("cf1", [False, True])
@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_local_matches(arch, dp, cf1, monkeypatch):
    _check_local(monkeypatch, arch, dp, cf1, 2, 16, seed=0)


@pytest.mark.parametrize("cf1", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_local_matches_where_tokens_drop(arch, cf1, monkeypatch):
    """T = 512 tokens with a shared component over 2 shards: 160 slots
    an expert a shard (128 under cf 1.0) for 512 entries on 4 experts;
    the favoured expert overflows in each shard, and which entries it
    drops follows that shard's stable sort."""
    keep = _check_local(monkeypatch, arch, 2, cf1, 2, 256, seed=1,
                        common=1.0)
    assert 0 < (~keep).sum() < keep.size
    for half in np.split(keep, 2):
        assert (~half).any()


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_local_gradients_match(arch, dp, monkeypatch):
    """``jax.vjp`` of the reference's ``moe_ffn_local`` against autograd
    through the port's, with a normal cotangent on y and 0.5 on aux, for
    the input and every MoE leaf (the router's through the gates and
    aux; the experts' through the bf16 combine); tokens drop."""
    jcfg, p, pcfg, moe = _cfgs(arch, False)
    moe.requires_grad_(True)
    x = _x(2, 128, jcfg.d_model, seed=4, common=1.0)
    ct = jnp.asarray(np.random.default_rng(5).standard_normal(x.shape),
                     jnp.bfloat16)
    _reference_mesh(monkeypatch, dp)
    (y, aux), vjp = jax.vjp(lambda a, b: JL.moe_ffn_local(a, b, jcfg), p, x)
    gp, gx = vjp((ct, jnp.float32(0.5)))
    xt = _t(x).requires_grad_(True)
    params = dict(moe.named_parameters())
    with _port_mesh(dp):
        py, paux = PL.moe_ffn_local(moe, xt, pcfg)
    got = torch.autograd.grad((py, paux), [xt] + list(params.values()),
                              (_t(ct), torch.tensor(0.5)))
    want = [gx] + [convert._flatten(gp)[n] for n in params]
    for name, g, w in zip(["x"] + list(params), got, want):
        w = np.asarray(w, np.float32)
        assert torch.isfinite(g).all(), name
        rel = float(np.linalg.norm(g.float().numpy() - w)
                    / np.linalg.norm(w))
        assert rel <= LAYER_GRAD_REL, (name, rel)


def test_one_shard_is_moe_ffn():
    """With a mesh of one data shard (``make_host_mesh()`` without a
    process group) or none, ``moe_ffn_local`` is ``moe_ffn`` bit for bit,
    as is a token count that does not split over the shards."""
    _, _, pcfg, moe = _layer("deepseek-moe-16b")
    x = _t(_x(1, 6, pcfg.d_model, seed=2))
    with torch.no_grad():
        want = PL.moe_ffn(moe, x, pcfg)
        with PAPI.mesh_context(make_host_mesh()) as mesh:
            assert mesh.shape == (1, 1) and PAPI.processes() == 1
            got = PL.moe_ffn_local(moe, x, pcfg)
        with _port_mesh(4):                       # 6 tokens, 4 shards
            uneven = PL.moe_ffn_local(moe, x, pcfg)
    for a in (got, uneven):
        assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])


def test_combine_sums_each_token_in_bf16_in_expert_order(monkeypatch):
    """The local combine adds each token's kept gated outputs from 0 in
    bf16, one rounding a term, in ascending expert order: y equals that
    loop written out on the host over the recorded routes and expert
    outputs (phi3.5, no shared expert, at top_k 3: two terms round alike
    in bf16 steps and once from f32, three need not), and differs from
    the once-rounded f32 sum; two runs give equal bits, forward and
    backward."""
    _, _, pcfg, moe = _layer("phi3.5-moe-42b-a6.6b")
    pcfg = dataclasses.replace(pcfg, top_k=3)
    assert not pcfg.n_shared_experts
    moe.requires_grad_(True)
    x = _t(_x(2, 64, pcfg.d_model, seed=3, common=1.0))
    ct = torch.randn(x.shape, generator=torch.Generator().manual_seed(0)
                     ).bfloat16()
    dp, D = 2, pcfg.d_model
    log, outs = [], []
    _record_port_routes(monkeypatch, log)
    experts = PL.moe_experts
    monkeypatch.setattr(PL, "moe_experts", lambda *a: outs.append(
        experts(*a)) or outs[-1])
    runs = []
    for _ in range(2):
        xr = x.clone().requires_grad_(True)
        with _port_mesh(dp):
            y, _ = PL.moe_ffn_local(moe, xr, pcfg)
        runs.append((y.detach(), *torch.autograd.grad(
            y, [xr] + list(moe.parameters()), ct)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out = outs[-1].detach()
    Tl = x.shape[0] * x.shape[1] // dp
    want = torch.zeros((dp * Tl, D), dtype=torch.bfloat16)
    once = torch.zeros((dp * Tl, D), dtype=torch.float32)
    dropped = 0
    for g, (r, C) in enumerate(log[-dp:]):
        st, se = r.st.numpy(), r.se.numpy()
        for t in range(Tl):
            for e in sorted(r.eidx[t].tolist()):
                j = int(np.flatnonzero((st == t) & (se == e))[0])
                if not r.keep[j]:
                    dropped += 1
                    continue
                term = out[e, g * C + int(r.pos[j])] \
                    * r.sg[j].to(torch.bfloat16)
                want[g * Tl + t] = want[g * Tl + t] + term
                once[g * Tl + t] += term.float()
    assert dropped
    assert torch.equal(runs[0][0].reshape(-1, D), want)
    assert not torch.equal(once.bfloat16(), want)


# --- a whole smoke model -----------------------------------------------------------


def _record_reference_local(monkeypatch, log, dp):
    """Log each call of the reference's ``moe_ffn_local`` (its shards
    together, tokens in shard order) as a ``torch_parity.Routing``."""
    orig = JL.moe_ffn_local

    def rec(p, x, cfg):
        B, S, D = x.shape
        E, K = cfg.n_experts, cfg.top_k
        Tl = B * S // dp
        cf = 1.0 if cfg.opt_moe_cf1 else cfg.capacity_factor
        C = max(8, int(Tl * K * cf / E))
        probs = jax.nn.softmax(x.reshape(dp, Tl, D).astype(jnp.float32)
                               @ p["router"], axis=-1)
        _, eidx = jax.lax.top_k(probs, K)
        fe = eidx.reshape(dp, Tl * K)
        order = jnp.argsort(fe, axis=1)
        se = jnp.take_along_axis(fe, order, 1)
        starts = jax.vmap(lambda r: jnp.searchsorted(r, jnp.arange(E)))(se)
        pos = jnp.arange(Tl * K)[None] - jnp.take_along_axis(starts, se, 1)
        st = order // K + (jnp.arange(dp) * Tl)[:, None]
        jax.debug.callback(
            lambda pr, t, e, k: log.append(R._routing(
                B, S, np.asarray(pr).reshape(B * S, E), np.ravel(t),
                np.ravel(e), np.ravel(k))),
            probs, st, se, pos < C, ordered=True)
        return orig(p, x, cfg)
    monkeypatch.setattr(JL, "moe_ffn_local", rec)


def _group(calls, dp):
    """The port's per-shard ``moe_route`` calls as one Routing a layer."""
    out = []
    for i in range(0, len(calls), dp):
        rs = calls[i:i + dp]
        Tl = rs[0].probs.shape[0]
        out.append(R._routing(
            0, 0, torch.cat([r.probs for r in rs]).detach().numpy(),
            torch.cat([r.st + g * Tl for g, r in enumerate(rs)]).numpy(),
            torch.cat([r.se for r in rs]).numpy(),
            torch.cat([r.keep for r in rs]).numpy()))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_loss_with_local_dispatch(arch, monkeypatch):
    """``model.loss_fn`` of the smoke model with ``opt_moe_local_dispatch``
    on 2 data shards (B 2, S 32) against the reference's ``loss_fn``
    under the same mesh; the first layer routed otherwise (if any)
    differs only at near ties, and following the reference's experts
    the losses agree within LOSS_RTOL."""
    dp = 2
    jcfg = dataclasses.replace(jreg.get_config(arch).smoke_model(),
                               opt_moe_local_dispatch=True)
    pcfg = dataclasses.replace(preg.get_config(arch).smoke_model(),
                               opt_moe_local_dispatch=True)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    batch = JD.SyntheticLM(JD.DataConfig(jcfg.vocab, 32, 2)).batch(0)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    ref_log = []
    with monkeypatch.context() as m:
        _reference_mesh(m, dp, (JL, JLM, JS2S))
        _record_reference_local(m, ref_log, dp)
        jloss = float(jax.jit(lambda p, b: JM.loss_fn(jcfg, p, b))(
            params, {k: jnp.asarray(v) for k, v in batch.items()}))
    assert len(ref_log) == sum(k == "moe" for _, k in model.kinds)

    def run(m, patch):
        calls = []
        orig = PL.moe_route

        def route(p, xf, cfg, C):
            r = patch(orig(p, xf, cfg, C), C)
            calls.append(r)
            return r
        m.setattr(PL, "moe_route", route)
        with torch.no_grad(), _port_mesh(dp):
            return float(PM.loss_fn(pcfg, model, tb)), _group(calls, dp)

    with monkeypatch.context() as m:
        _, own = run(m, lambda r, C: r)
    R.check_routing(ref_log, own, jcfg.top_k)
    shards = iter([np.split(np.nonzero(c.chosen)[1].reshape(
        len(c.chosen), -1), dp) for c in ref_log])
    want = iter([e for layer in shards for e in layer])
    with monkeypatch.context() as m:
        ploss, followed = run(m, lambda r, C: PL.moe_assign(
            r.probs, torch.as_tensor(next(want)), C))
    assert [(c.chosen == f.chosen).all() for c, f in zip(
        ref_log, followed)] == [True] * len(ref_log)
    assert abs(ploss - jloss) / abs(jloss) <= LOSS_RTOL, (ploss, jloss)


def test_world_one_step_is_todays_step():
    """``make_step`` on a smoke MoE model with ``opt_moe_local_dispatch``
    under ``make_host_mesh()`` with no process group (a (1, 1) mesh)
    gives the same losses and parameters bit for bit as with no mesh."""
    cfg = dataclasses.replace(
        preg.get_config("deepseek-moe-16b").smoke_model(),
        opt_moe_local_dispatch=True)
    data = PD.SyntheticLM(PD.DataConfig(cfg.vocab, 16, 4))
    oc = PA.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)

    def train(mesh):
        model = PM.init_params(cfg, 0, "cpu").requires_grad_(True)
        state = PA.init(dict(model.named_parameters()))
        step = PT.make_step(cfg, oc, PT.TrainConfig(microbatches=2))
        with PAPI.mesh_context(mesh):
            losses = [step(model, state, data.torch_batch(s, "cpu"))["loss"]
                      for s in range(2)]
        return losses, model
    (l0, m0), (l1, m1) = train(None), train(make_host_mesh())
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for (n, a), (_, b) in zip(m0.named_parameters(), m1.named_parameters()):
        assert torch.equal(a, b), n
