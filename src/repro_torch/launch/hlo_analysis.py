"""Roofline terms and collective traffic of a dry-run step.

Counterpart of ``repro.launch.hlo_analysis``. One formula,
:func:`wire`, gives a collective's operand bytes and its modelled ring
bytes on the wire from its kind, its result's bytes and its group size.
Two readers share it: :func:`collective_stats` parses XLA's HLO text as
the reference does (kept so that the formula can be held to the
reference on the same HLO lines), and :func:`collective_stats_from_log`
reads the port's own record of the collectives a torch step issued
(``parallel.spmd.Recorder``: kind, result bytes, group size each).

:func:`roofline_terms` takes the device's peak rate, memory rate and
link rate as arguments: the reference's module constants are a TPU's,
and the port's dry run passes the card's figures and the modelled
fabric's link rate explicitly (``launch/dryrun.py``).
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"(?:^|\s)(all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(")
_TYPE_RE = re.compile(r"(pred|s8|u8|s16|u16|f16|bf16|s32|u32|f32|s64|u64|f64)"
                      r"\[([0-9,]*)\]")
# iota form: replica_groups=[num_groups,group_size]<=[...]
_GROUP_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_GROUP_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def _shape_bytes(m) -> int:
    dt, dims = m.group(1), m.group(2)
    n = 1
    for d in dims.split(","):
        if d.strip():
            n *= int(d)
    return n * _DTYPE_BYTES[dt]


def wire(kind: str, result_bytes: float, group: int) -> Tuple[float, float]:
    """(operand bytes, ring bytes on the wire) a device of a group of
    ``group`` moves for one collective whose result is ``result_bytes``:
    an all-reduce sends 2 (g-1)/g of its operand, an all-gather (g-1)/g
    of its result, a reduce-scatter (g-1) times its result, an all-to-all
    (g-1)/g of its operand, a collective-permute its operand once."""
    g = max(group, 1)
    b = result_bytes
    if kind == "all-reduce":
        return b, 2.0 * b * (g - 1) / g
    if kind == "all-gather":
        return b / g, b * (g - 1) / g
    if kind == "reduce-scatter":
        return b * g, b * (g - 1)
    if kind == "all-to-all":
        return b, b * (g - 1) / g
    if kind == "collective-permute":
        return b, float(b)
    raise ValueError(f"unknown collective kind {kind!r}")


def _add(stats, kind: str, result_bytes: float, group: int) -> None:
    operand, w = wire(kind, result_bytes, group)
    s = stats[kind]
    s["count"] += 1
    s["operand_bytes"] += operand
    s["wire_bytes"] += w


def _stats():
    return defaultdict(lambda: {"count": 0, "operand_bytes": 0.0,
                                "wire_bytes": 0.0})


def collective_stats(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Per collective kind of an SPMD HLO text: count, operand bytes and
    modelled ring bytes on the wire per device (:func:`wire`), sized from
    each op's result type (the last one of a tuple) and its replica
    group's size, as the reference reads them."""
    stats = _stats()
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if m is None:
            continue
        if "=" not in line[:m.start() + 1]:
            continue
        type_region = line[line.index("=") + 1:m.start()]
        types = list(_TYPE_RE.finditer(type_region))
        if not types:
            continue
        g = 1
        gm = _GROUP_IOTA_RE.search(line)
        if gm:
            g = int(gm.group(2))
        else:
            gm = _GROUP_LIST_RE.search(line)
            if gm:
                g = len([x for x in gm.group(1).split(",") if x.strip()])
        _add(stats, m.group(1), _shape_bytes(types[-1]), g)
    return dict(stats)


def collective_stats_from_log(records: Iterable[Tuple[str, int, int]]
                              ) -> Dict[str, Dict[str, float]]:
    """The same statistics from a log of (kind, result bytes, group size),
    one record a collective the step issued."""
    stats = _stats()
    for kind, result_bytes, group in records:
        _add(stats, kind, result_bytes, group)
    return dict(stats)


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float, chips: int, *,
                   peak_flops: float, hbm_bytes_per_s: float,
                   link_bytes_per_s: float, links_per_chip: int
                   ) -> Dict[str, float]:
    """Three roofline terms in seconds (totals = per device x chips):
    compute at ``peak_flops`` a chip, memory at ``hbm_bytes_per_s`` a
    chip, collectives at ``links_per_chip`` links of
    ``link_bytes_per_s``; the dominant one, and the compute term's share
    of it."""
    total_flops = flops_per_dev * chips
    total_bytes = bytes_per_dev * chips
    total_wire = wire_bytes_per_dev * chips
    t_compute = total_flops / (chips * peak_flops)
    t_memory = total_bytes / (chips * hbm_bytes_per_s)
    t_collective = total_wire / (chips * link_bytes_per_s * links_per_chip)
    terms = {"t_compute": t_compute, "t_memory": t_memory,
             "t_collective": t_collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["roofline_fraction"] = terms[dom] and max(
        t_compute / max(terms[dom], 1e-30), 0.0)
    return terms


def model_flops(active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference) with N active params."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_params * tokens
