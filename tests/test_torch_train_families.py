"""Training of the MoE, SSM and hybrid families: the port against the
JAX package's, on the CPU.

deepseek-moe-16b, phi3.5-moe, mamba2-2.7b and jamba-v0.1-52b at
``smoke_model()``, reference weights from ``PRNGKey(0)`` carried over by
``convert.params_from_jax``, batches from ``repro.data.synthetic``,
other inputs from numpy seeds. Both packages run with ``remat=False``
(``dataclasses.replace``): ``torch_parity.follow_reference`` pairs MoE
calls by their order, and under ``torch.utils.checkpoint`` the port
calls ``moe_route`` again in the backward's recompute. A separate test
holds the port's remat on and off to each other bit for bit. MoE archs
run first with their own routing, which may part from the reference's
only at a near tie (``torch_parity.check_routing``), then again
choosing the reference's experts, and that run is compared.

Tolerances, each with its reason:
- the SSD at chunk 128 (mamba2's and jamba's default): gradients within
  ``SSD_GRAD_REL`` 1e-5 relative of ``jax.grad`` of the reference's own
  step-by-step oracle ``ssd_sequential`` (f32 sums in another order;
  measured 4.3e-6 at chunk 128, in A's gradient, a sum over every
  position, and 2.2e-7 at 16); the forward bit for bit equal to the
  unmasked expression.
- the dispatch backward: within one bf16 rounding of autograd's plain
  gather (``DISPATCH_ULP``: both round a sum of at most ``top_k`` bf16
  rows, the plain one in bf16 steps, this one once from f32), and equal
  bits over two runs.
- the loss: 1e-2 relative, as the dense family's (bf16 forward).
- gradients: per leaf ``||g - g_ref|| / ||g_ref||`` under
  ``GRAD_REL[arch]``, twice the worst leaf measured (see its comment);
  one Mamba or MoE layer's under ``LAYER_GRAD_REL`` 2e-2.
- three ``make_step`` steps: losses within 1e-2 relative, parameters
  within ``PARAM_REL[arch]`` over all leaves, twice the measured.
- AdamW on float32 leaves: moments rtol 1e-6 of themselves (unclipped),
  parameters within 1e-6 relative plus one f32 step of the update.

Caveat R3 (ROADMAP §3): this module's fixture turns JAX's x64 mode off
while its tests run, as ``test_torch_train.py`` does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as R
from repro.configs import registry as jreg
from repro.data import synthetic as JD
from repro.models import layers as JL, model as JM
from repro.optim import adamw as JA
from repro.train import loop as JT
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.data import synthetic as PD
from repro_torch.launch import train as PTRAIN
from repro_torch.models import layers as PL, model as PM
from repro_torch.optim import adamw as PA
from repro_torch.train import loop as PT

ARCHS = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
         "jamba-v0.1-52b"]
SSD_GRAD_REL = 1e-5
DISPATCH_ULP = 2.0 ** -8
# per-leaf relative gradient error ||g - g_ref|| / ||g_ref||, measured on
# the CPU (JAX 0.9.0, torch 2.13) on the run that follows the reference's
# experts, the bound twice the worst leaf: deepseek 0.0174 (layer 1's
# router), phi3.5 0.0145 (a wq), mamba2 0.0154 (a dt_bias), jamba 0.0861
# (a dt_bias). jamba's leaves all lie 0.021-0.086 apart, its embedding
# and MLPs at 0.04 too: the residual stream that puts its forward
# logits 0.121 from the reference's (torch_parity.MODEL_TOL) carries the
# bf16 drift into every gradient, and the Mamba reductions over positions
# (dt_bias, A_log, D) cancel most. One Mamba or MoE layer alone agrees
# within LAYER_GRAD_REL (test_layer_gradients_match).
GRAD_REL = {
    "deepseek-moe-16b": 0.035,
    "phi3.5-moe-42b-a6.6b": 0.029,
    "mamba2-2.7b": 0.031,
    "jamba-v0.1-52b": 0.17,
}
# parameters after three steps over all leaves, ||p - p_ref|| / ||p_ref||,
# twice the worst of the plain and the two-microbatch int8 runs: deepseek
# 0.00227, phi3.5 0.00223, mamba2 0.00352 (int8; 0.00192 plain), jamba
# 0.00434
PARAM_REL = {
    "deepseek-moe-16b": 0.0046,
    "phi3.5-moe-42b-a6.6b": 0.0045,
    "mamba2-2.7b": 0.0071,
    "jamba-v0.1-52b": 0.0087,
}
# one bf16 layer's gradients, per leaf and for its input: a few bf16 steps
# (test_torch_moe.py's BF16_LAYER); measured 0.0053 (Mamba), see the test
LAYER_GRAD_REL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-width training is many small ops: intra-op threads only add
    overhead, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _x64_off():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


def _t(x) -> torch.Tensor:
    return convert.tensor_from_numpy(np.asarray(x))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# --- the SSD at chunk 128 -------------------------------------------------------


def _ssd_inputs(L=256, H=4, P=8, N=8, seed=0):
    """mamba2's init ranges: dt uniform in [0.001, 0.1], A from -1 to
    -16; one group."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((1, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (1, L, H)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((1, L, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((1, L, 1, N)).astype(np.float32)
    cy = rng.standard_normal((1, L, H, P)).astype(np.float32)
    cs = rng.standard_normal((1, H, P, N)).astype(np.float32)
    return (xh, dt, A, Bm, Cm), (cy, cs)


def _ref_ssd_grad(fn, ins, cts):
    def loss(*a):
        y, s = fn(*a)
        return jnp.sum(y * cts[0]) + jnp.sum(s * cts[1])
    return jax.jit(jax.grad(loss, argnums=tuple(range(5))))(
        *map(jnp.asarray, ins))


def _port_ssd_grad(ins, cts, chunk):
    ts = [torch.as_tensor(a).requires_grad_(True) for a in ins]
    y, s = PL.ssd_chunked(*ts, chunk)
    loss = (y * torch.as_tensor(cts[0])).sum() + \
        (s * torch.as_tensor(cts[1])).sum()
    return (y, s), torch.autograd.grad(loss, ts)


def test_reference_ssd_gradient_has_nans_at_chunk_128():
    """Caveat R9: the reference's ``ssd_chunked`` computes ``exp(ddec)``
    above the diagonal, where it overflows at chunk 128 but not at 16,
    and its gradient takes NaN from ``0 * inf``."""
    ins, cts = _ssd_inputs()
    g128 = _ref_ssd_grad(functools.partial(JL.ssd_chunked, chunk=128),
                         ins, cts)
    g16 = _ref_ssd_grad(functools.partial(JL.ssd_chunked, chunk=16),
                        ins, cts)
    assert not np.isfinite(np.asarray(g128[3])).all()
    assert all(np.isfinite(np.asarray(g)).all() for g in g16)


@pytest.mark.parametrize("chunk", [16, 128])
def test_ssd_gradient_finite_and_matches_sequential(chunk):
    """The port's masked form: every gradient finite and within
    ``SSD_GRAD_REL`` of ``jax.grad`` of the reference's
    ``ssd_sequential``, the forward within 1e-5 of it too."""
    ins, cts = _ssd_inputs()
    want = _ref_ssd_grad(JL.ssd_sequential, ins, cts)
    (y, s), got = _port_ssd_grad(ins, cts, chunk)
    ys, ss = JL.ssd_sequential(*map(jnp.asarray, ins))
    assert _rel(y, ys) <= 1e-5 and _rel(s, ss) <= 1e-5
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= SSD_GRAD_REL, _rel(g, w)


def test_ssd_mask_keeps_forward_bits(monkeypatch):
    """The forward equals the unmasked ``exp(ddec)`` bit for bit; the
    unmasked form's gradient is where the NaNs came from."""
    ins, cts = _ssd_inputs()
    (y, s), got = _port_ssd_grad(ins, cts, 128)
    monkeypatch.setattr(PL, "_intra_decay", lambda ddec, tri: torch.exp(ddec))
    (y0, s0), bad = _port_ssd_grad(ins, cts, 128)
    assert torch.equal(y, y0) and torch.equal(s, s0)
    assert not torch.isfinite(bad[3]).all()
    assert all(torch.isfinite(g).all() for g in got)


# --- the MoE dispatch's backward ------------------------------------------------


def _dispatch_case(T=64, D=32, E=4, K=2, C=24, seed=0):
    """A route of T tokens over E experts with some dropped entries
    (capacity C < T K / E)."""
    rng = np.random.default_rng(seed)
    probs = torch.softmax(torch.as_tensor(
        rng.standard_normal((T, E)).astype(np.float32)) * 2, -1)
    r = PL.moe_assign(probs, torch.topk(probs, K)[1], C)
    xf = torch.as_tensor(rng.standard_normal((T, D)).astype(np.float32))
    ct = torch.as_tensor(rng.standard_normal((E, C, D)).astype(np.float32))
    return xf.bfloat16(), ct.bfloat16(), r, E, C


def _pad_rows(g: torch.Tensor) -> torch.Tensor:
    """(E, C, D) -> (E*C + 1, D) with a zero spare row."""
    return torch.cat([g.reshape(-1, g.shape[-1]),
                      g.new_zeros((1, g.shape[-1]))])


def test_dispatch_backward_sums_in_a_fixed_order():
    """The forward is the plain scatter's; the gradient is within one
    bf16 rounding of autograd's through the plain gather (per element,
    of the sum of the magnitudes of its terms) and equal bits over two
    runs; a dropped entry gives its token nothing."""
    xf, ct, r, E, C = _dispatch_case()
    assert not r.keep.all()

    def plain(x):
        flat = x.new_zeros((E * C + 1, x.shape[1]))
        flat[r.slot] = x[r.st]
        return flat[:E * C].view(E, C, -1)

    x0 = xf.clone().requires_grad_(True)
    want = plain(x0)
    (gwant,) = torch.autograd.grad(want, x0, ct)
    mag = torch.zeros_like(xf, dtype=torch.float32).index_add_(
        0, r.st, _pad_rows(ct)[r.slot].float().abs())
    runs = []
    for _ in range(2):
        x = xf.clone().requires_grad_(True)
        got = PL.moe_dispatch(x, r, E, C)
        assert torch.equal(got, want.detach())
        runs.append(torch.autograd.grad(got, x, ct)[0])
    assert runs[0].dtype == torch.bfloat16
    assert torch.equal(runs[0], runs[1])
    err = (runs[0].float() - gwant.float()).abs()
    assert bool((err <= DISPATCH_ULP * mag).all())
    dropped = torch.ones(len(xf), dtype=torch.bool)
    dropped[r.st[r.keep]] = False
    assert dropped.any() and not runs[0][dropped].any()


# --- loss and gradients ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    jcfg = dataclasses.replace(jreg.get_config(arch).smoke_model(),
                               remat=False)
    return jcfg, JM.init_params(jcfg, jax.random.PRNGKey(0))


def _pair(arch, remat=False):
    """(reference cfg, its params, port cfg, a fresh converted model with
    parameters that require grad)."""
    jcfg, params = _ref_params(arch)
    pcfg = dataclasses.replace(preg.get_config(arch).smoke_model(),
                               remat=remat)
    model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, params, pcfg, model.requires_grad_(True)


def _batch(cfg, B=2, S=32, seed=0):
    return JD.SyntheticLM(JD.DataConfig(cfg.vocab, S, B, seed=seed)).batch(0)


def _value_and_grad(pcfg, model, batch):
    params = dict(model.named_parameters())
    loss = PM.loss_fn(pcfg, model, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


def _follow(monkeypatch, ref_log, K, run):
    """``run()`` with the port's own routing, which must part from the
    reference's only at a near tie if at all; then ``run()`` again
    choosing the reference's experts, and that result."""
    own = []
    with monkeypatch.context() as m:
        R.record_port(m, own)
        run()
    R.check_routing(ref_log, own, K)
    with monkeypatch.context() as m:
        R.follow_reference(m, ref_log)
        return run()


def grad_errors(arch, monkeypatch):
    """(loss rel err, {leaf: ||g - g_ref|| / ||g_ref||}) of the port's
    loss and gradients against ``jax.value_and_grad(JM.loss_fn)``."""
    jcfg, params, pcfg, model = _pair(arch)
    batch = _batch(jcfg)
    log = []
    with monkeypatch.context() as m:
        R.record_reference(m, log)
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(jcfg, p, b)))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, pgrads = _follow(monkeypatch, log, jcfg.top_k,
                            lambda: _value_and_grad(pcfg, model, batch))
    want = convert._lm_state(jcfg, jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(pgrads)
    rel = {}
    for name, g in pgrads.items():
        w = np.asarray(want[name], np.float32)
        assert g.dtype == dict(model.named_parameters())[name].dtype
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        rel[name] = _rel(g, w) if np.linalg.norm(w) else \
            float(g.float().abs().max())
    return abs(float(ploss) - float(jloss)) / abs(float(jloss)), rel


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(arch, monkeypatch):
    """``jax.value_and_grad(M.loss_fn)`` (the cross entropy plus 0.01
    times the aux loss) against autograd through the port's loss, per
    parameter leaf under the port's names; the f32 leaves (the router,
    Mamba's ``A_log``, ``dt_bias`` and ``D``) take f32 gradients."""
    loss_rel, rel = grad_errors(arch, monkeypatch)
    assert loss_rel <= 1e-2
    worst = max(rel, key=rel.get)
    assert rel[worst] <= GRAD_REL[arch], (worst, rel[worst])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b"])
def test_remat_gives_equal_gradients(arch):
    """``torch.utils.checkpoint`` recomputes each layer (the MoE routing
    with it), and each jamba super-block whole as the reference does, to
    the same bits: the loss and every gradient equal with remat on and
    off."""
    _, _, pcfg, model = _pair(arch, remat=True)
    _, _, pcfg0, model0 = _pair(arch, remat=False)
    batch = _batch(pcfg)
    loss, grads = _value_and_grad(pcfg, model, batch)
    loss0, grads0 = _value_and_grad(pcfg0, model0, batch)
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name


# --- training steps --------------------------------------------------------------


def step_errors(arch, monkeypatch, microbatches=1, compression=None):
    """Three steps of the reference's ``make_step`` and the port's on the
    same weights and batches (B 4, S 32): the losses' relative errors
    and the parameters' over all leaves."""
    jcfg, params, pcfg, _ = _pair(arch)
    tc = dict(microbatches=microbatches, grad_compression=compression)
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    data = PD.SyntheticLM(PD.DataConfig(pcfg.vocab, 32, 4))
    log, jlosses = [], []
    with monkeypatch.context() as m:
        R.record_reference(m, log)
        jstep = jax.jit(JT.make_step(jcfg, JA.OptConfig(**oc),
                                     JT.TrainConfig(**tc)))
        jstate = JA.init(params)
        for step in range(3):
            params, jstate, jstats = jstep(params, jstate, {
                k: jnp.asarray(v) for k, v in data.batch(step).items()})
            jlosses.append(float(jstats["loss"]))

    def run():
        model = _pair(arch)[3]
        pstep = PT.make_step(pcfg, PA.OptConfig(**oc), PT.TrainConfig(**tc))
        pstate = PA.init(dict(model.named_parameters()))
        losses = [float(pstep(model, pstate, data.torch_batch(s, "cpu"))
                        ["loss"]) for s in range(3)]
        assert int(pstate["step"]) == 3
        return model, losses
    model, plosses = _follow(monkeypatch, log, jcfg.top_k, run)
    want = convert._lm_state(jcfg, jax.tree.map(np.asarray, params))
    num = sum(np.sum((_f32(p) - np.asarray(want[n], np.float32)) ** 2)
              for n, p in model.named_parameters())
    den = sum(np.sum(np.asarray(w, np.float32) ** 2) for w in want.values())
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 or str(want[n].dtype) == "bfloat16"
    return ([abs(a - b) / abs(b) for a, b in zip(plosses, jlosses)],
            float(np.sqrt(num / den)))


# the MoE arch with a shared expert and the SSM arch take two
# microbatches (summed in float32 buffers) and int8-compressed gradients,
# which carry their f32 leaves as the reference's do
STEP_OPTIONS = {"deepseek-moe-16b": (2, "int8"),
                "phi3.5-moe-42b-a6.6b": (1, None),
                "mamba2-2.7b": (2, "int8"),
                "jamba-v0.1-52b": (1, None)}


@pytest.mark.parametrize("arch", ARCHS)
def test_make_step_matches(arch, monkeypatch):
    loss_rel, param_rel = step_errors(arch, monkeypatch,
                                      *STEP_OPTIONS[arch])
    assert max(loss_rel) <= 1e-2, loss_rel
    assert param_rel <= PARAM_REL[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_gradients_match(arch):
    """One layer's VJP, ``jax.vjp`` against autograd, on bf16 inputs
    (B 2, S 32) and a normal cotangent: the Mamba mixer (``mamba_block``:
    conv, SSD at the smoke chunk of 16, gated norm) or the MoE FFN
    (``moe_ffn``, whose routing is the same on both sides here: the f32
    router sees equal inputs), per parameter leaf and for the input.
    The aux loss's gradient is not in the cotangent."""
    jcfg = jreg.get_config(arch).smoke_model()
    pcfg = preg.get_config(arch).smoke_model()
    if jcfg.family in ("ssm", "hybrid"):
        jfn, pfn = JL.mamba_block, PL.mamba_block
        p = JL.init_mamba(jax.random.PRNGKey(1), jcfg)
        mod = PL.Mamba(pcfg, "cpu")
    else:
        def jfn(p, x, cfg):
            return JL.moe_ffn(p, x, cfg)[0]

        def pfn(p, x, cfg):
            return PL.moe_ffn(p, x, cfg)[0]
        p = JL.init_moe(jax.random.PRNGKey(1), jcfg)
        mod = PL.MoE(pcfg, "cpu")
    mod = convert.module_params_from_jax(
        mod, jax.tree.map(np.asarray, p)).requires_grad_(True)
    rng = np.random.default_rng(0)
    x, ct = (jnp.asarray(rng.standard_normal((2, 32, jcfg.d_model)),
                         jnp.bfloat16) for _ in range(2))
    gp, gx = jax.jit(lambda pp, xx, cc: jax.vjp(
        lambda a, b: jfn(a, b, jcfg), pp, xx)[1](cc))(p, x, ct)
    xt = _t(x).requires_grad_(True)
    params = dict(mod.named_parameters())
    got = torch.autograd.grad(pfn(mod, xt, pcfg),
                              [xt] + list(params.values()), _t(ct))
    want = [gx] + [convert._flatten(gp)[n] for n in params]
    for name, g, w in zip(["x"] + list(params), got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= LAYER_GRAD_REL, (name, _rel(g, w))


# --- the optimizer, the converter, checkpoints and the launcher ---------------


def test_adamw_update_f32_leaves_matches():
    """One update at step 7 of f32 leaves beside a bf16 one, unclipped
    (grad norm ~0.2): f32 moments rtol 1e-6 of themselves; an f32
    parameter within 1e-6 of itself plus one f32 step of lr times its
    update (f32 sums in another order); the bf16 one within one bf16
    step. The f32 leaves are rounded nowhere but in f32, as the
    reference's ``astype(p.dtype)`` leaves them."""
    rng = np.random.default_rng(12)
    shapes = {"router": (16, 4), "A_log": (8,), "D": (8,), "w": (16, 8)}
    f32 = {"router", "A_log", "D"}
    params = {n: rng.standard_normal(s).astype(
        np.float32 if n in f32 else jnp.bfloat16) for n, s in shapes.items()}
    grads = {n: (rng.standard_normal(s) * 0.01).astype(params[n].dtype)
             for n, s in shapes.items()}
    m = {n: (rng.standard_normal(s) * 0.01).astype(np.float32)
         for n, s in shapes.items()}
    v = {n: (rng.random(s) * 1e-3).astype(np.float32)
         for n, s in shapes.items()}
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20)
    jp, js, jstats = JA.update(
        JA.OptConfig(**cfg), jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.int32(7)}, jax.tree.map(jnp.asarray, params))
    assert float(jstats["grad_norm"]) < 1.0
    tp = {n: _t(a) for n, a in params.items()}
    pp, ps, _ = PA.update(PA.OptConfig(**cfg),
                          {n: _t(a) for n, a in grads.items()},
                          {"m": {n: _t(a) for n, a in m.items()},
                           "v": {n: _t(a) for n, a in v.items()},
                           "step": torch.tensor(7, dtype=torch.int32)}, tp)
    lr = float(jstats["lr"])
    for n in shapes:
        for key in ("m", "v"):
            np.testing.assert_allclose(_f32(ps[key][n]),
                                       np.asarray(js[key][n]), rtol=1e-6)
        got, want = _f32(pp[n]), np.asarray(jp[n], np.float32)
        if n in f32:
            assert pp[n].dtype == torch.float32
            u = np.abs(want - params[n]) / lr
            tol = 1e-6 * np.abs(want) + lr * np.spacing(u.astype(np.float32))
        else:
            tol = np.abs(want) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(got - want) <= tol), n


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_from_jax(arch):
    """The reference's AdamW state after one update of the family's tree
    (a hybrid's stacked super-block, an MoE's head and stacked body)
    maps onto the port's names bit for bit, f32 leaves included."""
    jcfg, params, _, model = _pair(arch)
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape), p.dtype), params)
    _, state, _ = jax.jit(functools.partial(JA.update, JA.OptConfig()))(
        grads, JA.init(params), params)
    got = convert.opt_state_from_jax(model, jax.tree.map(np.asarray, state))
    assert int(got["step"]) == 1
    for key in ("m", "v"):
        want = convert._lm_state(jcfg, jax.tree.map(np.asarray, state[key]))
        assert list(got[key]) == [n for n, _ in model.named_parameters()]
        for n, t in got[key].items():
            np.testing.assert_array_equal(t.numpy(), want[n])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b"])
def test_resume_is_bit_exact(arch, tmp_path):
    """4 steps straight equal 2 steps, a checkpoint, a new ``Trainer`` and
    2 more, bit for bit: parameters (the f32 router and Mamba leaves
    too), moments, step and losses; the model remats per layer (jamba
    per super-block)."""
    cfg = preg.get_config(arch).smoke_model()
    assert cfg.remat

    def trainer(d, steps):
        return PT.Trainer(cfg, PD.DataConfig(cfg.vocab, 16, 2),
                          PA.OptConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=4),
                          PT.TrainConfig(steps=steps, ckpt_dir=str(d),
                                         ckpt_every=2), device="cpu")
    straight = trainer(tmp_path / "a", 4)
    losses = straight.run()["losses"]
    first = trainer(tmp_path / "b", 2)
    split = first.run()["losses"]
    second = trainer(tmp_path / "b", 4)
    assert second.start_step == 2
    assert split + second.run()["losses"] == losses
    for (n, p), q in zip(straight.model.named_parameters(),
                         second.model.parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), n
    for key in ("m", "v"):
        for n, t in straight.opt_state[key].items():
            assert torch.equal(t, second.opt_state[key][n]), n
    assert int(second.opt_state["step"]) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains(arch, tmp_path):
    out = PTRAIN.main(["--arch", arch, "--device", "cpu", "--smoke",
                       "--steps", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 2 and all(np.isfinite(out["losses"]))
