"""The training forward's remat plan and the ``opt_remat_dots`` policy:
the port against the JAX package's, on the CPU.

The reference (``repro.models.lm.forward``) runs the ``first_k_dense``
head layers without remat, scans a flat body under ``jax.checkpoint``
with ``dots_with_no_batch_dims_saveable`` when ``cfg.opt_remat_dots``
is set (``_remat_policy``), and a hybrid's super-blocks and an
encoder-decoder's stacks under plain ``jax.checkpoint``. The port keeps
the outputs of ``aten.mm`` / ``aten.addmm`` (``lm.save_dots``) through
``torch.utils.checkpoint``'s selective contexts.

- the plan: which layers each package recomputes, and how, read from
  the reference's ``scan_blocks`` calls, against ``lm.remat_plan``;
- the saved set: per layer kind, the count and sizes of the tensors
  the port's policy keeps equal those of the reference's
  ``dot_general``s with no batch dimension (``jax.make_jaxpr`` of the
  same layer, sub-jaxprs included); the hybrid and the
  encoder-decoder keep none;
- exactness: loss and every gradient under the policy equal plain remat
  bit for bit; against ``jax.value_and_grad`` of the reference under
  its policy within the tolerances of ``test_torch_train.py`` (dense,
  ``GRAD_REL`` 0.046) and ``test_torch_train_families.py`` (mamba2,
  0.031), loss 1e-2 relative: bf16 forwards rounded in another order;
- the head layers run outside ``checkpoint``, their values unchanged.

Reference weights come from ``PRNGKey(0)`` through
``convert.params_from_jax``; batches from ``repro.data.synthetic``.
Caveat R3 (ROADMAP §3): the fixture turns JAX's x64 mode off.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import synthetic as JD
from repro.models import lm as jlm, model as JM, seq2seq as js2s
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.models import lm as plm, model as PM

FLAT = ("qwen2.5-3b", "deepseek-moe-16b", "mamba2-2.7b")
ALL = FLAT + ("jamba-v0.1-52b", "seamless-m4t-medium")
# per-leaf ||g - g_ref|| / ||g_ref|| bounds of the plain-remat parity
# tests (test_torch_train.py GRAD_REL; test_torch_train_families.py
# GRAD_REL["mamba2-2.7b"])
GRAD_REL = {"qwen2.5-3b": 0.046, "mamba2-2.7b": 0.031}


@pytest.fixture(scope="module", autouse=True)
def _x64_off_one_thread():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.config.update("jax_enable_x64", was)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jreg.get_config(arch).smoke_model(), **kw)
    pcfg = dataclasses.replace(preg.get_config(arch).smoke_model(), **kw)
    return jcfg, pcfg


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    jcfg = jreg.get_config(arch).smoke_model()
    return jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))


def _model(pcfg, arch):
    return convert.params_from_jax(pcfg, _ref_params(arch),
                                   device="cpu").requires_grad_(True)


def _batch(cfg, B=2, S=32):
    b = JD.SyntheticLM(JD.DataConfig(cfg.vocab, S, B, seed=0)).batch(0)
    if cfg.family == "encdec":
        b["frames"] = np.random.default_rng(7).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return b


def _value_and_grad(pcfg, model, batch):
    params = dict(model.named_parameters())
    loss = PM.loss_fn(pcfg, model, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


def _reference_plan(jcfg, monkeypatch):
    """The reference's remat per unit of its scan: each ``scan_blocks``
    call covers its stack's length of units, a layer each or, for a
    hybrid, a super-block of ``hybrid_period`` layers under one
    ``jax.checkpoint``; what no call covers (the head) runs without
    remat."""
    calls = []

    def rec(orig):
        def scan_blocks(body, carry, xs, **kw):
            n = jax.tree.leaves(xs)[0].shape[0]
            if not kw.get("remat"):
                kind = None
            elif kw.get("remat_policy") is None:
                kind = "plain"
            else:
                assert kw["remat_policy"] is \
                    jax.checkpoint_policies.dots_with_no_batch_dims_saveable
                kind = "dots"
            calls.append([kind] * n)
            return orig(body, carry, xs, **kw)
        return scan_blocks

    monkeypatch.setattr(jlm, "scan_blocks", rec(jlm.scan_blocks))
    monkeypatch.setattr(js2s, "scan_blocks", rec(js2s.scan_blocks))
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    jax.eval_shape(lambda p: JM.loss_fn(jcfg, p, batch),
                   JM.init_params(jcfg, jax.random.PRNGKey(0)))
    covered = [k for c in calls for k in c]
    n = jcfg.enc_layers + jcfg.dec_layers if jcfg.family == "encdec" \
        else jcfg.n_layers // jcfg.hybrid_period if jcfg.family == "hybrid" \
        else jcfg.n_layers
    return [None] * (n - len(covered)) + covered


@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("dots", [False, True])
def test_remat_plan_matches_reference(arch, dots, monkeypatch):
    """Head layers without remat, a hybrid's super-blocks and a flat body
    without the flag under plain remat, a flat body with it under the
    dots policy; an encoder-decoder under plain remat throughout (the
    port's ``seq2seq`` reads no ``opt_remat_dots``)."""
    jcfg, pcfg = _cfgs(arch, opt_remat_dots=dots)
    want = _reference_plan(jcfg, monkeypatch)
    if pcfg.family == "encdec":
        assert want == ["plain"] * len(want)
        return
    assert plm.remat_plan(pcfg) == want
    assert plm.remat_plan(dataclasses.replace(pcfg, remat=False)) == \
        [None] * len(want)


def _no_batch_dots(jaxpr, out):
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            (_, _), (lb, _) = e.params["dimension_numbers"]
            if not lb:
                out.append(int(np.prod(e.outvars[0].aval.shape)))
        for v in e.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _no_batch_dots(inner, out)
    return out


def _reference_layer_dots(jcfg, arch, B=2, S=32):
    """Sizes of the no-batch ``dot_general`` outputs of one body layer."""
    mixer, ffn = jlm._plan(jcfg)["body"]
    lp = jax.tree.map(lambda a: a[0], _ref_params(arch)["blocks"])
    x = jnp.zeros((B, S, jcfg.d_model), jnp.bfloat16)
    pos = jnp.arange(S)
    jaxpr = jax.make_jaxpr(lambda p, x: jlm._layer_fwd(
        jcfg, mixer, ffn, p, x, pos)[0])(lp, x)
    return sorted(_no_batch_dots(jaxpr.jaxpr, []))


def _port_saved(pcfg, model, batch, monkeypatch):
    """Sizes of the outputs the port's policy keeps in one training
    forward (not its recompute), and every op it was asked about."""
    saved, seen = [], []
    save_dots = plm.save_dots

    def policy(ctx, op, *args, **kwargs):
        choice = save_dots(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append(op)
            if choice == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
                a, b = args[-2:]
                saved.append(a.shape[0] * b.shape[1])
        return choice

    monkeypatch.setattr(plm, "save_dots", policy)
    PM.loss_fn(pcfg, model, {k: torch.as_tensor(v)
                             for k, v in batch.items()})
    return saved, seen


@pytest.mark.parametrize("arch", FLAT)
def test_saved_set_matches_reference_dots(arch, monkeypatch):
    """Every body layer keeps exactly the reference's no-batch products
    (q, k, v, wo and the MLP's three for a dense layer; the router and
    the shared expert's for an MoE layer, not the experts' batched
    einsum; in_proj and out_proj for a Mamba layer, not the SSD's), with
    the weights requiring grad as in training: ``x @ w`` then folds to
    ``mm`` and never goes through ``bmm``. Attention's scores and PV are
    recomputed."""
    jcfg, pcfg = _cfgs(arch, opt_remat_dots=True)
    per_layer = _reference_layer_dots(jcfg, arch)
    assert per_layer
    model = _model(pcfg, arch)
    saved, seen = _port_saved(pcfg, model, _batch(jcfg), monkeypatch)
    n_body = plm.remat_plan(pcfg).count("dots")
    assert n_body == pcfg.n_layers - pcfg.first_k_dense > 0
    assert sorted(saved) == sorted(per_layer * n_body)
    assert torch.ops.aten.bmm.default in seen


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "seamless-m4t-medium"])
def test_hybrid_and_encdec_save_nothing(arch, monkeypatch):
    """The reference gives these no policy: with the flag set the port
    still recomputes their layers whole."""
    jcfg, pcfg = _cfgs(arch, opt_remat_dots=True)
    saved, seen = _port_saved(pcfg, _model(pcfg, arch), _batch(jcfg),
                              monkeypatch)
    assert saved == [] and seen == []


@pytest.mark.parametrize("arch", FLAT)
def test_dots_policy_equals_plain_remat_bit_for_bit(arch):
    """The kept products are the values the recompute would give, so the
    loss and every gradient equal plain remat's to the bit."""
    _, plain = _cfgs(arch)
    _, dots = _cfgs(arch, opt_remat_dots=True)
    batch = _batch(plain)
    l0, g0 = _value_and_grad(plain, _model(plain, arch), batch)
    l1, g1 = _value_and_grad(dots, _model(dots, arch), batch)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("arch", sorted(GRAD_REL))
def test_dots_policy_matches_reference_gradients(arch):
    """``jax.value_and_grad`` of the reference's loss under its own
    policy against the port's under ``save_dots``, per leaf."""
    jcfg, pcfg = _cfgs(arch, opt_remat_dots=True)
    batch = _batch(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b)))(
            jax.tree.map(jnp.asarray, _ref_params(arch)),
            {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, pgrads = _value_and_grad(pcfg, _model(pcfg, arch), batch)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-2)
    want = convert._lm_state(jcfg, jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(pgrads)
    for name, g in pgrads.items():
        w = np.asarray(want[name], np.float32)
        assert g.shape == w.shape, name
        ref = np.linalg.norm(w)
        got = g.detach().float().numpy()
        rel = np.linalg.norm(got - w) / ref if ref else np.abs(got).max()
        assert rel <= GRAD_REL[arch], (name, rel)


@pytest.mark.parametrize("dots", [False, True])
def test_head_blocks_run_outside_checkpoint(dots, monkeypatch):
    """deepseek's dense first layer runs without remat, its MoE body under
    ``checkpoint``; loss and gradients equal a run without remat to the
    bit."""
    arch = "deepseek-moe-16b"
    _, pcfg = _cfgs(arch, opt_remat_dots=dots)
    assert pcfg.first_k_dense == 1
    model = _model(pcfg, arch)
    wrapped = []
    orig = plm.checkpoint

    def rec(fn, *args, **kw):
        wrapped.append(fn)
        return orig(fn, *args, **kw)

    monkeypatch.setattr(plm, "checkpoint", rec)
    batch = _batch(pcfg)
    l1, g1 = _value_and_grad(pcfg, model, batch)
    assert [[id(b) for b in unit.args[0]] for unit in wrapped] == \
        [[id(b)] for b in model.blocks[pcfg.first_k_dense:]]
    off = dataclasses.replace(pcfg, remat=False)
    l0, g0 = _value_and_grad(off, _model(off, arch), batch)
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_hybrid_remats_one_input_a_super_block():
    """A hybrid runs each super-block of ``hybrid_period`` layers under
    one ``checkpoint``, as the reference scans them under one
    ``jax.checkpoint``: outside the checkpoints the layers keep one
    input a super-block (the checkpoint's saved inputs: x, the positions
    and the aux carry), not one a layer. jamba's smoke widths cut to two
    super-blocks (16 layers); the loss and every gradient equal those of
    the same weights with ``remat=False`` bit for bit."""
    arch = "jamba-v0.1-52b"
    base = preg.get_config(arch).smoke_model()
    P = base.hybrid_period
    pcfg = dataclasses.replace(base, n_layers=2 * P)
    assert plm.remat_plan(pcfg) == ["plain", "plain"]
    model = PM.init_params(pcfg, seed=0, device="cpu").requires_grad_(True)
    B, S = 2, 32
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, pcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    x.requires_grad_(True)
    positions = torch.arange(S)
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, aux = plm.run_blocks(model, x, positions)
    inputs = [t for t in packed if t.shape == x.shape]
    assert len(inputs) == 2 and inputs[0] is x
    with torch.no_grad():
        mid, _ = plm.run_layers(model.blocks[:P], x, positions,
                                torch.zeros(()))
    assert torch.equal(inputs[1], mid)
    rest = [t for t in packed if t.shape != x.shape]
    assert len(rest) == 4
    assert all(t.dim() == 0 or torch.equal(t, positions) for t in rest)

    off = dataclasses.replace(pcfg, remat=False)
    batch = _batch(pcfg)
    l1, g1 = _value_and_grad(pcfg, model, batch)
    l0, g0 = _value_and_grad(off, PM.init_params(off, seed=0, device="cpu")
                             .requires_grad_(True), batch)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
