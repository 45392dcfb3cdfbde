"""Device timing of a kernel on the card, shared by ``chip_smoke.py`` and
the ``bench_*`` scripts. Both run ``fn`` once first, as a warm-up."""
from __future__ import annotations

import torch

# profiler traces device_ms takes at most, until one holds the kernel
TRACES = 5


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


def device_ms(fn, reps: int, name: str) -> dict:
    """Mean device time of the kernels whose name holds ``name`` that
    ``reps`` calls of ``fn`` launch, from a profiler trace: the kernel
    alone, without the host's dispatch between calls. The mean is over
    the kernels the trace holds: the profiler has been seen to drop some
    of 100 back-to-back launches, and all of them in three traces in a
    row, so a trace that holds none is taken again, up to ``TRACES`` in
    all. Returns ``{"device_ms": t, "device_ms_source": "profiler"}``; if
    no trace holds the kernel, ``t`` is :func:`cuda_ms`'s (CUDA events
    around back-to-back calls, the host's dispatch included) and the
    source ``"events"``, so a reader can tell the two apart."""
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
            return {"device_ms": sum(spans) / len(spans) / 1e3,
                    "device_ms_source": "profiler"}
    return {"device_ms": cuda_ms(fn, reps), "device_ms_source": "events"}


def bound_share(bound_ms: float, row: dict):
    """``bound_ms`` over the kernel's device time in ``row`` (from
    :func:`device_ms`), or None where that time came from CUDA events
    and so holds the host's dispatch too."""
    if row["device_ms_source"] != "profiler":
        return None
    return bound_ms / row["device_ms"]
