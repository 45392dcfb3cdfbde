"""Device timing of a kernel on the card, shared by ``chip_smoke.py`` and
the ``bench_*`` scripts. Both run ``fn`` once first, as a warm-up."""
from __future__ import annotations

import torch

# profiler traces device_ms takes at most, until one holds the kernel
TRACES = 3


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls
    (CUDA events, so the host's dispatch between calls is included)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int, name: str) -> float:
    """Mean device time of the kernels whose name holds ``name`` that
    ``reps`` calls of ``fn`` launch, from a profiler trace: the kernel
    alone, without the host's dispatch between calls. The mean is over
    the kernels the trace holds: the profiler has been seen to drop some
    of 100 back-to-back launches, and once all of them, so a trace that
    holds none is taken again, up to ``TRACES`` in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name]
        if spans:
            return sum(spans) / len(spans) / 1e3
    raise RuntimeError(f"{TRACES} profiler traces saw no {name} kernel")
