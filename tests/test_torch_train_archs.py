"""Three AdamW steps of the dense archs beyond qwen2.5-3b: the port
against the JAX package's, on the CPU.

gemma-7b, stablelm-12b, qwen1.5-32b and internvl2-2b at
``smoke_model()``: the reference's ``jax.jit(make_step)`` and the
port's ``make_step`` take three steps (B 4, S 32, lr 1e-3, warm-up 1)
from the same weights (``PRNGKey(0)`` carried over by
``convert.params_from_jax``) on the same synthetic batches; the vision
arch's ``patches`` are drawn from ``default_rng(step)`` as the
reference's launcher draws them, and the port takes them from its own
launcher's ``extra_inputs``. ``chip_smoke.py`` holds each arch's CUDA
run to its CPU run with these bounds.

Tolerances, each with its reason:
- the losses: 1e-2 relative (bf16 forward, as ``test_torch_train.py``).
- the parameters over all leaves, ``||p - p_ref|| / ||p_ref||``:
  ``PARAM_REL[arch]``, twice the reading measured here (see its
  comment). Per leaf it says little: Adam turns the bf16 noise of a
  near-zero gradient into a full-size step of either sign.

Caveat R10 (ROADMAP §3): a vision arch's batch shorter than its
``n_vision_tokens`` prefix raises in both packages.

Caveat R3 (ROADMAP §3): this module's fixture turns JAX's x64 mode off
while its tests run, as ``test_torch_train.py`` does.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import synthetic as JD
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.train import loop as JT
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.data import synthetic as PD
from repro_torch.launch import train as PTRAIN
from repro_torch.models import model as PM
from repro_torch.optim import adamw as PA
from repro_torch.train import loop as PT

ARCHS = ["gemma-7b", "stablelm-12b", "qwen1.5-32b", "internvl2-2b"]
B, S = 4, 32
# parameters after three steps over all leaves, twice the reading measured
# on the CPU (JAX 0.9.0, torch 2.13), rounded up: gemma-7b 0.00245,
# stablelm-12b 0.00241, qwen1.5-32b 0.00240, internvl2-2b 0.00248 (losses
# within 2.2e-4); qwen2.5-3b reads 0.0024-0.0025 too (test_torch_train.py)
PARAM_REL = {
    "gemma-7b": 0.0049,
    "stablelm-12b": 0.0049,
    "qwen1.5-32b": 0.0048,
    "internvl2-2b": 0.0050,
}


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


def _pair(arch):
    """(reference cfg, its params, port cfg, the converted model with
    parameters that require grad)."""
    jcfg = jreg.get_config(arch).smoke_model()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    pcfg = preg.get_config(arch).smoke_model()
    model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, params, pcfg, model.requires_grad_(True)


def _ref_patches(cfg, step):
    """The reference launcher's ``patches`` of ``step``
    (``src/repro/launch/train.py``)."""
    rng = np.random.default_rng(step)
    return rng.normal(size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(
        np.float32)


def step_errors(arch):
    """Three steps of each package: the losses' relative errors and the
    parameters' over all leaves."""
    jcfg, params, pcfg, model = _pair(arch)
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    data = PD.SyntheticLM(PD.DataConfig(pcfg.vocab, S, B))
    extra = PTRAIN.extra_inputs(pcfg, B, S, "cpu")
    assert (extra is None) == (not jcfg.n_vision_tokens)
    jstep = jax.jit(JT.make_step(jcfg, JA.OptConfig(**oc), JT.TrainConfig()))
    pstep = PT.make_step(pcfg, PA.OptConfig(**oc), PT.TrainConfig())
    jstate = JA.init(params)
    pstate = PA.init(dict(model.named_parameters()))
    loss_rel = []
    for step in range(3):
        jb = {k: jnp.asarray(v) for k, v in data.batch(step).items()}
        if extra:
            jb["patches"] = jnp.asarray(_ref_patches(jcfg, step))
        params, jstate, jstats = jstep(params, jstate, jb)
        pstats = pstep(model, pstate, data.torch_batch(
            step, "cpu", extra(step) if extra else None))
        loss_rel.append(abs(float(pstats["loss"]) - float(jstats["loss"]))
                        / abs(float(jstats["loss"])))
    assert int(pstate["step"]) == 3
    want = convert._lm_state(jcfg, jax.tree.map(np.asarray, params))
    assert set(want) == {n for n, _ in model.named_parameters()}
    num = sum(np.sum((_f32(p) - np.asarray(want[n], np.float32)) ** 2)
              for n, p in model.named_parameters())
    den = sum(np.sum(np.asarray(w, np.float32) ** 2) for w in want.values())
    return loss_rel, float(np.sqrt(num / den))


@pytest.mark.parametrize("arch", ARCHS)
def test_make_step_matches(arch):
    """Covers GeGLU with the tied 256k-row embedding at hd 256 (gemma),
    LayerNorm with an untied head at hd 160 (stablelm), multi-head
    attention without GQA (qwen1.5) and the vision prefix through
    ``vis_proj`` (internvl2)."""
    loss_rel, param_rel = step_errors(arch)
    assert max(loss_rel) <= 1e-2, loss_rel
    assert param_rel <= PARAM_REL[arch], param_rel


def test_chip_smoke_holds_these_bounds():
    """``chip_smoke.py`` trains each of these archs on the card and holds
    its CUDA steps to its CPU steps within this file's bounds."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for arch in ARCHS:
        assert arch in smoke.TRAIN_FAMILY_ARCHS
        assert smoke.TRAIN_FAMILY_PARAM_REL[arch] == PARAM_REL[arch]


def test_launcher_patches_are_the_references():
    """``extra_inputs`` draws the vision arch's patches as the reference's
    launcher does, bit for bit."""
    cfg = preg.get_config("internvl2-2b").smoke_model()
    extra = PTRAIN.extra_inputs(cfg, B, S, "cpu")
    for step in (0, 5):
        got = extra(step)["patches"]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), _ref_patches(cfg, step))


def test_vision_prefix_longer_than_batch_raises(tmp_path):
    """Caveat R10: the reference adds its ``n_vision_tokens`` patch
    embeddings to the first positions with ``x.at[:, :n].add``, which
    raises when the batch is shorter than the prefix; the port's in-place
    add raises too, and so does its launcher at such a ``--seq``."""
    jcfg, params, pcfg, model = _pair("internvl2-2b")
    short = jcfg.n_vision_tokens // 2
    batch = JD.SyntheticLM(JD.DataConfig(jcfg.vocab, short, 2)).batch(0)
    batch["patches"] = np.zeros((2, jcfg.n_vision_tokens, jcfg.d_model),
                                np.float32)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        JM.loss_fn(jcfg, params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    with pytest.raises(RuntimeError, match="must match"):
        PM.loss_fn(pcfg, model, {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    with pytest.raises(RuntimeError, match="must match"):
        PTRAIN.main(["--arch", "internvl2-2b", "--device", "cpu", "--smoke",
                     "--steps", "1", "--seq", str(short),
                     "--ckpt-dir", str(tmp_path)])
