"""The sharded training step (``parallel.spmd``) of the SSM, hybrid and
encoder-decoder families on the CPU: mamba2-2.7b, jamba-v0.1-52b (one
super-block of 8 layers) and seamless-m4t-medium, the last also at a
vocabulary of 511 that does not divide over "model"
(``torch_spmd_workers.FAMILY_CASES``).

The same method and bounds as ``test_torch_spmd.py``, whose checks run
here on these cases: four gloo ranks on a ("data", "model") (2, 2) mesh
against one process and against the reference's step jitted on the
same mesh of forced host devices (losses within ``LOSS_RTOL``, grad
norms within ``LAYER_GRAD_REL``, parameters within the arch's
``PARAM_REL``; jamba's MoE through the near-tie rule); a world of one
rank on (1, 1) bit for bit with today's step; ``shard_state`` then
``gather_state`` lossless; every rank's collectives equal the fake
trace's. Besides:
- the Mamba mixer unplanned (every head, no group: what a (1, 1) mesh
  plans) gives ``layers.mamba_block``'s output and gradients bit for
  bit;
- at (2, 2) each Mamba mixer reads ``in_proj``, ``conv_w`` (gathered)
  and ``conv_b``, ``dt_bias``, ``A_log``, ``D``, ``norm_w`` (sliced)
  through views, and ``out_proj``'s row block as it is stored.
"""
import numpy as np
import pytest
import torch

import test_torch_spmd as TS
import torch_spmd_workers as W
from repro_torch.models import layers as PL, model as PM
from repro_torch.parallel import spmd
from test_torch_spmd import _one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return TS.run_reference(tmp_path_factory, W.FAMILY_CASES)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, reference):
    return TS.run_four_ranks(tmp_path_factory, reference, W.FAMILY_CASES)


@pytest.mark.parametrize("case", list(W.FAMILY_CASES))
def test_four_ranks_match_one_process(case, four_ranks, reference):
    TS.check_one_process(case, four_ranks, reference)


@pytest.mark.parametrize("case", list(W.FAMILY_CASES))
def test_four_ranks_match_the_reference(case, four_ranks, reference):
    TS.check_reference(case, four_ranks, reference)


@pytest.mark.parametrize("arch", list(W.FAMILY_CASES))
def test_real_collectives_equal_the_fake_trace(arch, four_ranks):
    TS.check_fake_trace(arch, four_ranks)


def test_world_one_is_todays_step(tmp_path):
    """The three archs (``torch_spmd_workers.FAMILY_ARCHS``)."""
    TS.check_world_one(tmp_path, W.FAMILY_ARCHS)


@pytest.mark.parametrize("shape", TS.SHAPES)
@pytest.mark.parametrize("arch", W.FAMILY_ARCHS)
def test_shard_state_then_gather_is_lossless(arch, shape):
    TS.check_shard_gather(arch, shape)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_unplanned_mamba_mixer_is_mamba_block(arch):
    """Seed-0 weights of the arch's first Mamba layer and a normal x
    (numpy seed 0, bf16): output, and gradients of x and of every
    weight for a normal cotangent, equal bit for bit."""
    cfg = W.smoke(arch)
    whole = PM.init_params(cfg, 0, "cpu")
    p = next(b.mamba for b in whole.blocks if b.mixer == "mamba")
    mine = spmd.Mamba(cfg, "cpu")
    with torch.no_grad():
        for n, t in p.named_parameters():
            mine.get_parameter(n).copy_(t)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(2, W.S, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    ct = torch.as_tensor(rng.normal(size=x.shape).astype(np.float32)).to(
        torch.bfloat16)
    outs = []
    for m, f in ((p, lambda xx: PL.mamba_block(p, xx, cfg)),
                 (mine, mine.blocked)):
        m.requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        y = f(xx)
        outs.append([y] + list(torch.autograd.grad(
            y, [xx] + list(m.parameters()), ct)))
    assert mine.views == {} and mine.group is None
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)


MAMBA_VIEWS = ["A_log", "D", "conv_b", "conv_w", "dt_bias", "in_proj",
               "norm_w"]


@pytest.mark.parametrize("case", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_mamba_reads_its_heads_through_views(case, four_ranks):
    cfg = W.smoke(case)
    for r in four_ranks:
        views = r[case]["views"]
        mixers = {n: v for n, v in views.items() if n.endswith(".mamba")}
        assert len(mixers) == sum(cfg.mixer_kind(i) == "mamba"
                                  for i in range(cfg.n_layers))
        assert all(v == MAMBA_VIEWS for v in mixers.values()), mixers
