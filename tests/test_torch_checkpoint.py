"""The port's checkpoints and resumable trainer, on the CPU.

The on-disk contract of ``repro.checkpoint.manager`` (``tmp-<step>``
renamed to ``step-<step>``, one ``leaf{i}.npy`` per tensor with bf16
stored as float32, ``manifest.json``, ``keep`` retention, async saves),
and the trainer's resume: 4 steps straight equal 2 steps, a checkpoint,
a new ``Trainer`` and 2 more, bit for bit. Everything is exact here: no
tolerance.
"""
import json
import signal

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry as preg
from repro_torch.data.synthetic import DataConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import TrainConfig, Trainer


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"emb": torch.randn(8, 4, generator=g).bfloat16(),
                       "blocks.0.ln1": torch.randn(4, generator=g).bfloat16()},
            "opt": {"m": {"emb": torch.randn(8, 4, generator=g)},
                    "step": torch.tensor(3, dtype=torch.int32)}}


def _flat(state):
    return [state["params"]["emb"], state["params"]["blocks.0.ln1"],
            state["opt"]["m"]["emb"], state["opt"]["step"]]


def _equal(a, b):
    for x, y in zip(_flat(a), _flat(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_format_and_retention(tmp_path):
    """Leaves in the tree's insertion order, bf16 as float32, int32 as
    is; the manifest; no ``tmp-`` left (a stale one is replaced); the
    latest 3 kept."""
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "tmp-10").mkdir()
    (tmp_path / "tmp-10" / "junk").write_text("x")
    state = _state()
    mgr.save(10, state, blocking=True)
    d = tmp_path / "step-10"
    man = json.loads((d / "manifest.json").read_text())
    assert man["step"] == 10 and man["n_leaves"] == 4
    assert man["treedef"] == ("params.emb,params.blocks.0.ln1,opt.m.emb,"
                              "opt.step")
    assert sorted(p.name for p in d.iterdir()) == [
        "leaf0.npy", "leaf1.npy", "leaf2.npy", "leaf3.npy", "manifest.json"]
    assert not (tmp_path / "tmp-10").exists()
    for i, t in enumerate(_flat(state)):
        a = np.load(d / f"leaf{i}.npy")
        want = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        assert a.dtype == np.dtype(str(want).split(".")[-1])
        np.testing.assert_array_equal(a, t.to(want).numpy())
    for s in (20, 30, 40):
        mgr.save(s, state, blocking=True)
    assert mgr.all_steps() == [20, 30, 40] and mgr.latest_step() == 40
    mgr.save(40, _state(1), blocking=True)      # an existing step: kept
    _equal(mgr.restore(40, state), state)


def test_restore_casts_back_and_checks_structure(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = _state()
    mgr.save(1, state, blocking=True)
    got = mgr.restore(1, _state(5))
    _equal(got, state)
    assert got["params"]["emb"].device.type == "cpu"
    other = _state()
    other["params"]["extra"] = torch.zeros(2)
    with pytest.raises(ValueError, match="structure"):
        mgr.restore(1, other)
    renamed = _state()
    renamed["params"]["ln_f"] = renamed["params"].pop("blocks.0.ln1")
    with pytest.raises(ValueError, match="structure"):
        mgr.restore(1, renamed)


def test_async_save_copies_before_returning(tmp_path):
    """``save`` copies every leaf to the host before it returns, so the
    trainer may change its tensors in place while the thread writes."""
    mgr = CheckpointManager(tmp_path)
    state = _state()
    want = {k: v.clone() for k, v in enumerate(_flat(state))}
    mgr.save(5, state)
    for t in _flat(state):
        t.add_(1)
    mgr.wait()
    assert mgr._thread is not None and not mgr._thread.is_alive()
    got = _flat(mgr.restore(5, state))
    for i, t in enumerate(got):
        assert torch.equal(t, want[i])


def test_bf16_round_trip_through_npy(tmp_path):
    """bf16 values round-trip exactly (f32 holds every bf16)."""
    vals = np.arange(-2**15, 2**15, dtype=np.int32).astype(np.uint16)
    t = torch.from_numpy(vals.view(np.int16)).view(torch.bfloat16)
    t = t[torch.isfinite(t)]
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": t}, blocking=True)
    got = mgr.restore(1, {"a": torch.zeros_like(t)})["a"]
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))


# --- the trainer -------------------------------------------------------------


def _trainer(ckpt_dir, steps, seq=16, **tc):
    cfg = preg.get_config("qwen2.5-3b").smoke_model()
    return Trainer(cfg, DataConfig(cfg.vocab, seq, 2),
                   OptConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                   TrainConfig(steps=steps, ckpt_dir=str(ckpt_dir),
                               log_every=100, **tc),
                   seed=0, device="cpu")


def _snapshot(tr):
    out = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    for key in ("m", "v"):
        out.update({f"{key}.{n}": t.clone()
                    for n, t in tr.opt_state[key].items()})
    out["step"] = tr.opt_state["step"].clone()
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_resume_is_bit_exact(tmp_path):
    """4 steps straight against 2 steps, a checkpoint, a new Trainer and
    2 more: parameters, moments, step and losses equal; two straight runs
    equal too."""
    straight = _trainer(tmp_path / "a", 4)
    out = straight.run()
    assert out["final_step"] == 4 and len(out["losses"]) == 4
    again = _trainer(tmp_path / "b", 4)
    assert again.run()["losses"] == out["losses"]
    _same(_snapshot(again), _snapshot(straight))

    first = _trainer(tmp_path / "c", 2)
    first_out = first.run()
    second = _trainer(tmp_path / "c", 4)
    assert second.start_step == 2 and int(second.opt_state["step"]) == 2
    second_out = second.run()
    assert second_out["final_step"] == 4
    assert first_out["losses"] + second_out["losses"] == out["losses"]
    _same(_snapshot(second), _snapshot(straight))
    assert second.ckpt.all_steps() == [2, 4]
    assert all(p.requires_grad for p in second.model.parameters())


def test_async_saves_every_k_steps_and_final_save(tmp_path):
    tr = _trainer(tmp_path, 5, ckpt_every=2)
    assert tr.run()["final_step"] == 5
    assert tr.ckpt.all_steps() == [2, 4, 5]


def test_preemption_saves_and_stops(tmp_path):
    """A SIGTERM during training ends the run after the step in flight,
    with a checkpoint; the previous handlers come back afterwards."""
    tr = _trainer(tmp_path, 4)
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    step_fn = tr.step_fn

    def preempted(*a):
        signal.raise_signal(signal.SIGTERM)
        return step_fn(*a)
    tr.step_fn = preempted
    out = tr.run()
    assert out["final_step"] == 1 and len(out["losses"]) == 1
    assert tr.ckpt.all_steps() == [1]
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before


def test_straggler_watchdog_counts_slow_steps(tmp_path, monkeypatch):
    """A step more than ``straggler_factor`` x the running median (from
    the 8th step on) counts as a straggler: the host clock is stubbed so
    step 9 takes 10 s against 1 s for the others."""
    import types
    import repro_torch.train.loop as loop
    tr = _trainer(tmp_path, 10, ckpt_every=100)
    ticks = iter([0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
                  9, 19])
    monkeypatch.setattr(loop, "time",
                        types.SimpleNamespace(time=lambda: next(ticks)))
    out = tr.run()
    assert out["step_times"] == [1] * 9 + [10]
    assert out["stragglers"] == 1
