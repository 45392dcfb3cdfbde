"""Training of the encoder-decoder family: the port against the JAX
package's, on the CPU.

seamless-m4t-medium at ``smoke_model()`` (2 encoder and 2 decoder layers,
d_model 256, LayerNorm, GeGLU, vocab 512), reference weights from
``PRNGKey(0)`` carried over by ``convert.params_from_jax``; tokens from
``repro.data.synthetic``, frames normal from ``default_rng(step)`` as
both launchers draw them. The training forward runs every attention
through ``layers.blocked_attention`` (the reference's jnp path) and each
layer of both stacks under ``torch.utils.checkpoint``; prefill keeps the
flash kernel. Both packages run the comparisons with ``remat=False``, as
``test_torch_train_families.py`` does; a separate test holds the port's
remat on and off to each other bit for bit.

Tolerances, each with its reason:
- forward logits: the largest gap within ``FORWARD_GAP``, twice the
  measured (see its comment; ``test_torch_seq2seq.py`` holds the same
  forward to ``torch_parity.MODEL_TOL``).
- the loss: 1e-2 relative (bf16 forward), as the other families'.
- gradients: per leaf ``||g - g_ref|| / ||g_ref||`` under ``GRAD_REL``,
  twice the worst leaf measured.
- three ``make_step`` steps: losses within 1e-2 relative, parameters
  within ``PARAM_REL`` over all leaves, twice the measured.

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

from repro.configs import registry as jreg
from repro.data import synthetic as JD
from repro.models import model as JM, seq2seq as js2s
from repro.optim import adamw as JA
from repro.train import loop as JT
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.data import synthetic as PD
from repro_torch.kernels import ops
from repro_torch.launch import train as PTRAIN
from repro_torch.models import model as PM, seq2seq as ps2s
from repro_torch.optim import adamw as PA
from repro_torch.train import loop as PT

ARCH = "seamless-m4t-medium"
# the largest |logit| gap of the blocked training forward to the
# reference's forward (B 2, S 24, f32 frames), measured on the CPU 0.0586
# (the flash-based forward on the same inputs: 0.0488); both two bf16
# steps at these logits' largest |4.16| (a step there is 0.031), as the
# two round their matmuls in other orders. Bound twice it.
FORWARD_GAP = 0.12
# per-leaf relative gradient error, measured on the CPU (JAX 0.9.0, torch
# 2.13): worst leaf 0.0222 (layer 1's cross-attention wq); bound twice it
GRAD_REL = 0.045
# parameters after three steps over all leaves, twice the worst of the
# plain (0.00284) and the two-microbatch int8 (0.00333) runs
PARAM_REL = 0.0067


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


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _ref_params():
    jcfg = dataclasses.replace(jreg.get_config(ARCH).smoke_model(),
                               remat=False)
    return jcfg, JM.init_params(jcfg, jax.random.PRNGKey(0))


def _pair(remat=False):
    """(reference cfg, its params, port cfg, a fresh converted model with
    parameters that require grad)."""
    jcfg, params = _ref_params()
    pcfg = dataclasses.replace(preg.get_config(ARCH).smoke_model(),
                               remat=remat)
    model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, params, pcfg, model.requires_grad_(True)


def _frames(cfg, B, S, step):
    return np.random.default_rng(step).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _batch(cfg, B=2, S=24, step=0):
    b = JD.SyntheticLM(JD.DataConfig(cfg.vocab, S, B)).batch(step)
    return dict(b, frames=_frames(cfg, B, S, step))


def _value_and_grad(pcfg, model, batch):
    params = dict(model.named_parameters())
    loss = PM.loss_fn(pcfg, model, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


# --- F1: the training forward -----------------------------------------------------


def test_training_forward_never_calls_flash_and_remats(monkeypatch):
    """``seq2seq.forward`` under autograd runs blocked attention in every
    encoder and decoder layer (self and cross), each layer under one
    ``torch.utils.checkpoint``; the backward reaches every attention
    weight. Prefill still takes the flash wrapper: once per encoder
    layer and twice per decoder layer."""
    cfg = preg.get_config(ARCH).smoke_model()
    assert cfg.remat
    model = PM.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    calls, ckpts = [], []
    flash, ckpt = ops.flash_attention, ps2s.checkpoint
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    monkeypatch.setattr(ps2s, "checkpoint",
                        lambda *a, **kw: ckpts.append(1) or ckpt(*a, **kw))
    b = _batch(cfg)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    PM.loss_fn(cfg, model, tb).backward()
    assert calls == []
    assert len(ckpts) == cfg.enc_layers + cfg.dec_layers
    for blk in list(model.enc_blocks) + list(model.dec_blocks):
        for attn in [blk.attn] + ([blk.xattn] if hasattr(blk, "xattn")
                                  else []):
            assert attn.wq.grad is not None and attn.wq.grad.any()
    with torch.no_grad():
        PM.prefill_fn(cfg, model, {"frames": tb["frames"],
                                   "tokens": tb["tokens"]})
    assert len(calls) == cfg.enc_layers + 2 * cfg.dec_layers


def test_blocked_forward_matches_reference():
    """The training forward's logits against the reference's
    ``seq2seq.forward`` (its jnp blocked attention): the largest gap
    within ``FORWARD_GAP``."""
    jcfg, params, _, model = _pair()
    b = _batch(jcfg)
    want = js2s.forward(jcfg, params, jnp.asarray(b["frames"]),
                        jnp.asarray(b["tokens"]))
    with torch.no_grad():
        got = ps2s.forward(model, torch.as_tensor(b["frames"]),
                           torch.as_tensor(b["tokens"]))
    gap = float(np.abs(_f32(got) - np.asarray(want, np.float32)).max())
    assert gap <= FORWARD_GAP, gap


# --- loss and gradients --------------------------------------------------------------


def grad_errors():
    """(loss rel err, {leaf: ||g - g_ref|| / ||g_ref||}) against
    ``jax.value_and_grad(JM.loss_fn)``."""
    jcfg, params, pcfg, model = _pair()
    b = _batch(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: JM.loss_fn(jcfg, p, bb)))(
            params, {k: jnp.asarray(v) for k, v in b.items()})
    ploss, pgrads = _value_and_grad(pcfg, model, b)
    want = convert._seq2seq_state(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(pgrads)
    rel = {}
    for name, g in pgrads.items():
        w = np.asarray(want[name], np.float32)
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        rel[name] = float(np.linalg.norm(_f32(g) - w) / np.linalg.norm(w))
    return abs(float(ploss) - float(jloss)) / abs(float(jloss)), rel


def test_loss_and_gradients_match():
    """``jax.value_and_grad(M.loss_fn)`` against autograd through the
    port's loss (no aux term), per parameter leaf of both stacks under
    the port's names."""
    loss_rel, rel = grad_errors()
    assert loss_rel <= 1e-2
    worst = max(rel, key=rel.get)
    assert rel[worst] <= GRAD_REL, (worst, rel[worst])


def test_remat_gives_equal_gradients():
    _, _, pcfg, model = _pair(remat=True)
    _, _, pcfg0, model0 = _pair(remat=False)
    b = _batch(pcfg)
    loss, grads = _value_and_grad(pcfg, model, b)
    loss0, grads0 = _value_and_grad(pcfg0, model0, b)
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name


def test_model_loss_is_seq2seq_loss():
    cfg = preg.get_config(ARCH).smoke_model()
    model = PM.init_params(cfg, seed=0, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        assert torch.equal(PM.loss_fn(cfg, model, tb),
                           ps2s.loss_fn(model, tb))


# --- training steps, converter, checkpoints, launcher ------------------------------


def step_errors(microbatches=1, compression=None):
    """Three steps of the reference's ``make_step`` and the port's on the
    same weights and batches (B 4, S 32, frames of each step): the
    losses' relative errors and the parameters' over all leaves."""
    jcfg, params, pcfg, model = _pair()
    tc = dict(microbatches=microbatches, grad_compression=compression)
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(JT.make_step(jcfg, JA.OptConfig(**oc),
                                 JT.TrainConfig(**tc)))
    pstep = PT.make_step(pcfg, PA.OptConfig(**oc), PT.TrainConfig(**tc))
    jstate, pstate = JA.init(params), PA.init(dict(model.named_parameters()))
    loss_rel = []
    for step in range(3):
        b = _batch(jcfg, B=4, S=32, step=step)
        params, jstate, jstats = jstep(
            params, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstats = pstep(model, pstate,
                       {k: torch.as_tensor(v) for k, v in b.items()})
        loss_rel.append(abs(float(pstats["loss"]) - float(jstats["loss"]))
                        / abs(float(jstats["loss"])))
    want = convert._seq2seq_state(jax.tree.map(np.asarray, params))
    num = sum(np.sum((_f32(p) - np.asarray(want[n], np.float32)) ** 2)
              for n, p in model.named_parameters())
    den = sum(np.sum(np.asarray(w, np.float32) ** 2) for w in want.values())
    return loss_rel, float(np.sqrt(num / den))


@pytest.mark.parametrize("microbatches,compression", [(1, None), (2, "int8")])
def test_make_step_matches(microbatches, compression):
    """``make_step`` carries ``frames`` through the microbatch split and
    the int8 option."""
    loss_rel, param_rel = step_errors(microbatches, compression)
    assert max(loss_rel) <= 1e-2, loss_rel
    assert param_rel <= PARAM_REL, param_rel


def test_opt_state_from_jax():
    _, params, _, model = _pair()
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape), p.dtype), params)
    _, state, _ = jax.jit(functools.partial(JA.update, JA.OptConfig()))(
        grads, JA.init(params), params)
    got = convert.opt_state_from_jax(model, jax.tree.map(np.asarray, state))
    assert int(got["step"]) == 1
    for key in ("m", "v"):
        want = convert._seq2seq_state(jax.tree.map(np.asarray, state[key]))
        assert list(got[key]) == [n for n, _ in model.named_parameters()]
        for n, t in got[key].items():
            np.testing.assert_array_equal(t.numpy(), want[n])


def test_resume_is_bit_exact(tmp_path):
    """An ``EncDecLM`` trained 4 steps straight equals 2 steps, a
    checkpoint, a new ``Trainer`` and 2 more, bit for bit; the frames
    come from ``extra_batch``."""
    cfg = preg.get_config(ARCH).smoke_model()

    def trainer(d, steps):
        return PT.Trainer(
            cfg, PD.DataConfig(cfg.vocab, 16, 2),
            PA.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4),
            PT.TrainConfig(steps=steps, ckpt_dir=str(d), ckpt_every=2),
            extra_batch=lambda step: {"frames": torch.as_tensor(
                _frames(cfg, 2, 16, step))}, device="cpu")
    straight = trainer(tmp_path / "a", 4)
    losses = straight.run()["losses"]
    split = trainer(tmp_path / "b", 2).run()["losses"]
    second = trainer(tmp_path / "b", 4)
    assert second.start_step == 2
    assert split + second.run()["losses"] == losses
    for (n, p), q in zip(straight.model.named_parameters(),
                         second.model.parameters()):
        assert torch.equal(p, q), n
    for key in ("m", "v"):
        for n, t in straight.opt_state[key].items():
            assert torch.equal(t, second.opt_state[key][n]), n


def test_launcher_trains_seamless(tmp_path):
    """The launcher's frames extra (B, seq, d_model), drawn as the
    reference's launcher draws it, reaches the loss."""
    out = PTRAIN.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                       "--steps", "3", "--seq", "32",
                       "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and all(np.isfinite(out["losses"]))
    assert (tmp_path / "step-3" / "manifest.json").exists()
