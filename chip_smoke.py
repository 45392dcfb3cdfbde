"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels from the sources in this checkout (all three at once), measures the
issue rates of the instructions the (min,+) kernel is built from, holds
each kernel and each of its paths against its plain torch version on
the card, drives the four main paths at full size -- route-and-simulate
(PT 8x8x8 and the synthesized TONS_SYM 256 fabric, and the APSP of the
full PT 16^3 pod), the fault-tolerant path (every simulator mode held
CUDA against CPU and dense against CSR at 4x4x8; an OCS fault mid-sweep
under static and adaptive escape-VC routing and the hotspot acceptance
at PT 8x8x8; a serving build and online repair of PDTT 8^3; the chaos
acceptance campaign on PDTT 8^3 with its replay), synthesis and
workload co-design (the csr_spmv kernel's DADD latency probe, the kernel
on the 4x8x8 and 8^3 synthesis LPs and on rows of up to 70,000 entries,
PDHG with its chunk as a CUDA graph equal on CUDA and the CPU, TONS
synthesis of 4x8x8 with PDHG rounds on the card and its routed fabric,
one graphed chunk of its first round against the CPU,
``evaluate_workload`` of a stored workload fabric) and serving (qwen2.5-3b at its published widths, 8
ragged requests through the port's ``Server``, then one 32768-token
prefill; then the MoE, SSM, hybrid and encoder-decoder families --
deepseek-moe-16b, mamba2-2.7b, jamba-v0.1-52b cut to 16 of its 32
layers, seamless-m4t-medium -- and the other five registered archs --
gemma-7b (head dim 256), stablelm-12b (160), internvl2-2b, qwen1.5-32b
cut to 56 of its 64 layers, phi3.5-moe cut to 24 of its 32 -- each at
its published widths, 6 requests served twice with equal token streams,
and its CPU-vs-CUDA case, internvl2-2b's with its patch embeddings) and
training (qwen2.5-3b at its published widths through ``Trainer``: 8
steps with an async checkpoint, then one step of 4096 tokens; the smoke
model's 3 steps on CUDA against the CPU, and a run resumed from a
checkpoint against a straight one, bit for bit; then mamba2-2.7b,
seamless-m4t-medium and deepseek-moe-16b cut to 6 of its 28 layers, 8
steps each at their published widths, and one forward and backward of
jamba cut to 8 of its 32 layers; those four archs' smoke models on CUDA
against the CPU and resumed; the SSD's gradient at chunk 128; the flash
kernel must not launch; qwen2.5-3b's steps again with ``opt_remat_dots``,
equal to plain remat bit for bit; the training dry run: three production
cells, qwen2.5-3b, deepseek-moe-16b and jamba-v0.1-52b at train_4k on a
fake group of 256 ranks, through ``launch/dryrun.py`` in processes of
their own, and qwen2.5-3b whole through the sharded step
``parallel/spmd`` on one NCCL rank, bit for bit with the plain step, its
collectives and peak held to the dry run's fake run of the same step,
then deepseek-moe-16b's cut, mamba2-2.7b and seamless-m4t-medium whole
through it, each bit for bit with its own training run; jamba's sharded
step is held on the CPU only, its cut being too large for one card
with AdamW; the serving dry run: qwen2.5-3b's prefill_32k and
decode_32k cells on fake CUDA tensors, equal to the CPU's, and the
sharded prefill and decode of qwen2.5-3b whole and deepseek-moe-16b's
cut on one NCCL rank, bit for bit with the plain ones, the flash
kernel's custom op timed against its bare wrapper) and the four torch
examples
(``examples/torch_*.py`` at their counterparts' settings, quickstart's
pod cut to 4^3, the routes and
the fault walkthrough's simulations held to the CPU) -- checks that the
simulator's, the LP solver's and the model's CUDA and CPU runs agree,
and prints one JSON line per result.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one) and the repository's
``src/``, ``examples/`` and ``benchmarks/results/`` beside this file. Imports nothing
of JAX or of the JAX package ``repro``. The last line of the output is
``{"ok": true, "device": {...}}``; any failed phase exits non-zero first.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from hashlib import sha256
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels.timing import (  # noqa: E402
    bound_share, cuda_ms, device_ms)

# Published H100 SXM memory rate (HBM3).
PEAK_BYTES = 3.35e12
FP32_LANES_PER_SM = 128
# dense BF16 tensor-core flops per SM per clock (989 TFLOP/s published)
BF16_FLOPS_PER_SM_CLOCK = 4096

# the serving main path: qwen2.5-3b at its published config
SERVE_ARCH = "qwen2.5-3b"
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_MAX_NEW = 4, 2048, 8, 32
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the flash kernel's timed geometries by head dim, (Hq, Hkv, S values):
# qwen2.5-3b's (hd 128), gemma-7b's (16/16, hd 256) and stablelm-12b's
# (32/8, hd 160)
FLASH_TIME = {128: (16, 2, (142, 891, 2048, 4096, 8192, 32768)),
              256: (16, 16, (2048, 4096, 8192)),
              160: (32, 8, (2048, 4096, 8192))}
# the long prefill: qwen2.5-3b's prefill_32k shape
LONG_S = 32768
# the other families' serving paths (ROADMAP items 6-9), in this order, at
# their published widths, then the other five registered archs: gemma-7b
# (hd 256, 17.1 GB of bf16 weights and 3.8 GB of 4 x 2048 KV cache),
# stablelm-12b (hd 160; 24.3 + 1.7 GB), internvl2-2b (3.8 + 0.8 GB),
# qwen1.5-32b, phi3.5-moe. Cuts: jamba to 16 of its 32 layers (2 of its 4
# period-8 super-blocks: 52 GB of bf16 weights of its 103 GB); qwen1.5-32b
# to 56 of 64 (62.0 + 9.4 GB; all 64 take 70.4 + 10.7 GB, which leaves
# under 5 GB of the card for init's temporaries and a prefill);
# phi3.5-moe to 24 of 32 (62.9 + 0.8 GB; all 32 take 83.7 GB of weights)
FAMILY_ARCHS = ("deepseek-moe-16b", "mamba2-2.7b", "jamba-v0.1-52b",
                "seamless-m4t-medium", "gemma-7b", "stablelm-12b",
                "internvl2-2b", "qwen1.5-32b", "phi3.5-moe-42b-a6.6b")
FAMILY_LAYERS = {"jamba-v0.1-52b": 16, "qwen1.5-32b": 56,
                 "phi3.5-moe-42b-a6.6b": 24}
# new tokens a request, cut from 16 for the time limit (PR 28: the dry
# run's phase; 32 decode steps a run at 16, ~16 at 8)
FAMILY_REQUESTS, FAMILY_MAX_NEW = 6, 8
# the port functions whose device time the family profiles split out
FAMILY_TAGS = {"moe": ("moe_route", "moe_dispatch", "moe_experts",
                       "moe_combine"),
               "ssm": ("_causal_conv", "ssd_chunked", "ssd_step")}
# the port's CPU and CUDA runs of one model: the reference's own tolerance
# between two bf16 lowerings of one model (test_models.py, prefill/decode
# against the full forward)
MODEL_RTOL, MODEL_ATOL = 0.06, 0.15
# the training path: qwen2.5-3b at full width through Trainer with the
# launcher's defaults, TRAIN_STEPS steps; then one step at train_4k's
# sequence length (configs/base.py)
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 4, 128, 3e-4
TRAIN_LONG_S = 4096
# the CPU tests' tolerances for 3 steps of the port against the reference
# (tests/test_torch_train.py: losses rtol 1e-2, PARAM_REL over all leaves)
TRAIN_LOSS_RTOL, TRAIN_PARAM_REL = 1e-2, 0.0077
# the smoke config's CPU-against-CUDA cases: the launcher's microbatches 1
# and 4 (opt_microbatch4), each held to the bounds above
TRAIN_MICROBATCHES = (1, 4)
# the other families' training (ROADMAP item 10b) at their published
# widths with the launcher's defaults, each on its own: mamba2-2.7b and
# seamless-m4t-medium whole; deepseek-moe-16b cut to 6 of its 28 layers
# (the dense first layer and 5 MoE layers: ~3.4e9 parameters, ~48 GB of
# training state; all 28 would need ~230 GB); jamba cut to one
# super-block (8 of 32 layers, ~13.3e9 parameters), which runs one
# forward and backward without the optimizer (AdamW's f32 moments would
# bring it to ~160 GB; bf16 parameters and gradients are ~53 GB). Then
# the five archs that only served until then, each cut to ~4.1e9
# parameters (~14 bytes a parameter at peak with f32 moments, as
# qwen2.5-3b's 3.09e9 peaked at 43.5 GB): internvl2-2b whole (1.89e9);
# gemma-7b 12 of 28 layers (4.11e9: its tied 256k-row embedding is 0.79e9
# of them), stablelm-12b 11 of 40 (4.08e9), qwen1.5-32b 5 of 64 (4.19e9),
# phi3.5-moe 3 of 32 (4.16e9: 16 experts a layer)
TRAIN_FAMILY_ARCHS = ("mamba2-2.7b", "seamless-m4t-medium",
                      "deepseek-moe-16b", "jamba-v0.1-52b", "internvl2-2b",
                      "gemma-7b", "stablelm-12b", "qwen1.5-32b",
                      "phi3.5-moe-42b-a6.6b")
TRAIN_FAMILY_LAYERS = {"deepseek-moe-16b": 6, "jamba-v0.1-52b": 8,
                       "gemma-7b": 12, "stablelm-12b": 11, "qwen1.5-32b": 5,
                       "phi3.5-moe-42b-a6.6b": 3}
TRAIN_GRAD_ONLY = ("jamba-v0.1-52b",)
# the run length of the archs whose loss does not fall within TRAIN_STEPS:
# at lr 3e-4 Adam's first steps, near full size on every weight, throw
# these wide models' losses up (13.1 -> 15.6 by gemma-7b's third step; the
# CPU alike, one full-width layer) and 8 steps of the launcher's schedule
# end above the first loss; 16 end 2.7-3.9 below it, 24 4.3-5.5
# (train/bench_recipe.py)
TRAIN_FAMILY_STEPS = {"internvl2-2b": 16, "gemma-7b": 16, "stablelm-12b": 16,
                      "qwen1.5-32b": 16}
# the sequence length of an arch that cannot train at TRAIN_SEQ:
# internvl2-2b adds its 256 patch embeddings to the first 256 positions,
# which a shorter batch does not have (caveat R10, ROADMAP §3)
TRAIN_FAMILY_SEQ = {"internvl2-2b": 512}
# the archs whose smoke config resumes on the card: internvl2-2b's patches
# are the one input a resumed run redraws that the others do not cover
TRAIN_FAMILY_RESUME = ("mamba2-2.7b", "seamless-m4t-medium",
                       "deepseek-moe-16b", "jamba-v0.1-52b", "internvl2-2b")
# the CPU tests' bounds on the parameters after 3 steps of each arch
# against the reference (PARAM_REL of tests/test_torch_train_families.py,
# tests/test_torch_train_seq2seq.py and tests/test_torch_train_archs.py);
# losses within TRAIN_LOSS_RTOL
TRAIN_FAMILY_PARAM_REL = {"deepseek-moe-16b": 0.0046, "mamba2-2.7b": 0.0071,
                          "jamba-v0.1-52b": 0.0087,
                          "seamless-m4t-medium": 0.0067,
                          "internvl2-2b": 0.0050, "gemma-7b": 0.0049,
                          "stablelm-12b": 0.0049, "qwen1.5-32b": 0.0048,
                          "phi3.5-moe-42b-a6.6b": 0.0045}
# a router probability gap under which two lowerings may order two experts
# differently (tests/torch_parity.py NEAR_TIE)
NEAR_TIE = 1e-2
# the data-parallel path (ROADMAP item 10c): a world of one NCCL rank (the
# card's machine has one GPU); PARALLEL_STEPS of train_full's run again
# under make_host_mesh(), then deepseek-moe-16b at TRAIN_FAMILY_LAYERS' cut
# with the per-shard MoE dispatch over PARALLEL_SHARDS data shards that
# the one process holds, beside this run's figures for the same cut
# through moe_ffn (phase train_family_full)
PARALLEL_STEPS, PARALLEL_SHARDS = 3, 2
# the dry run (launch/dryrun.py, a fake group of 256 ranks, subprocesses):
# its production cells, and the sharded step at (1, 1) on one NCCL rank
# for PARALLEL_STEPS steps: qwen2.5-3b (its fake peak within
# DRYRUN_PEAK_REL of the card's), then DRYRUN_WORLD1_ARCHS at their
# train_family_full size (deepseek-moe-16b's cut, mamba2-2.7b and
# seamless-m4t-medium whole), each held to that run's losses. jamba's
# 8-layer cut does not fit one card with AdamW (57.8 GB for its forward
# and backward alone), so its sharded step is held on the CPU only
# (tests/test_torch_spmd_families.py); its production cell runs here
DRYRUN_ARCHS = ("qwen2.5-3b", "deepseek-moe-16b", "jamba-v0.1-52b")
DRYRUN_WORLD1_ARCHS = ("deepseek-moe-16b", "mamba2-2.7b",
                       "seamless-m4t-medium")
DRYRUN_PEAK_REL = 0.15
DRYRUN_TIMEOUT_S = 600
# the serving dry run (launch/dryrun.py at prefill_32k, decode_32k and
# long_500k): DRYRUN_SERVE_ARCH's production cells at DRYRUN_SERVE_SHAPES
# and DRYRUN_SERVE_LONG's B = 1 cell (the row whole on every rank, the kv
# cache's sequence over "data" and its head_dim over "model") on
# single_pod_16x16, on fake CUDA tensors and on fake CPU tensors, each in
# a process of its own; and the sharded prefill and decode (the sharded
# model's prefill / decode_step) on a (1, 1) mesh of one NCCL rank for
# DRYRUN_SERVE_WORLD1 (qwen2.5-3b whole with the serve prompts,
# deepseek-moe-16b at TRAIN_FAMILY_LAYERS' cut with the first
# FAMILY_REQUESTS of them, mamba2-2.7b whole, jamba at TRAIN_FAMILY_LAYERS'
# cut of one super-block and seamless-m4t-medium whole (zero frames of
# the prompt's length) with the first DRYRUN_SERVE_FAMILY_PROMPTS): each
# prompt prefilled alone, then DRYRUN_SERVE_STEPS greedy decode steps,
# bit for bit with model.prefill_fn / decode_fn on the same weights
DRYRUN_SERVE_ARCH = "qwen2.5-3b"
DRYRUN_SERVE_SHAPES = ("prefill_32k", "decode_32k")
DRYRUN_SERVE_LONG = ("jamba-v0.1-52b", "long_500k")
DRYRUN_SERVE_WORLD1 = ("qwen2.5-3b", "deepseek-moe-16b", "mamba2-2.7b",
                       "jamba-v0.1-52b", "seamless-m4t-medium")
DRYRUN_SERVE_FAMILY_PROMPTS = {"mamba2-2.7b": 2, "jamba-v0.1-52b": 2,
                               "seamless-m4t-medium": 2}
DRYRUN_SERVE_STEPS = 3
# a dry-run record's figures that the card's fake run must equal the CPU's
DRYRUN_RECORD_KEYS = ("flops_per_dev", "bytes_per_dev", "collectives",
                      "wire_bytes_per_dev",
                      "collective_operand_bytes_per_dev", "memory",
                      "model_flops", "useful_flop_ratio", "terms",
                      "flash_launches")
# calls a timing of the flash op's dispatch makes, at qwen2.5-3b's heads
# and a 128-token prompt (the kernel's device time is below the host's)
FLASH_DISPATCH_CALLS, FLASH_DISPATCH_S = 200, 128
# one MoE layer's output, CUDA against the CPU (tests/test_torch_moe.py's
# BF16_LAYER: of the row's largest |y|)
MOE_LAYER_ROW_REL = 2e-2
# the SSD's gradient at mamba2's head shapes and its default chunk of 128,
# CUDA against the CPU, per input (tests: 1e-5 against the reference's
# sequential oracle)
SSD_GRAD_REL = 1e-5
# the serving build and repair of the fault path: PDTT 8^3, cut from the
# reference's 12^3 (75-122 s of its build) to leave the examples room in
# the time limit
REPAIR_DIMS = (8, 8, 8)
# the torch examples (examples/torch_*.py) at their counterparts' settings;
# train_e2e at its docstring's full model (--d-model 768) for 30 steps, not
# its default 60 (26.9 s on a slow host) or the docstring's 300 (67-116 s
# on the card): the time limit
EXAMPLE_E2E_STEPS = 30
# quickstart on a 4^3 pod (its ``run``, as the CPU tests run it), cut from
# its counterpart's 4x4x8 for the time limit (HiGHS on the host: 122-146 s
# at 4x4x8 on the card's machine)
EXAMPLE_QUICKSTART_SPEC = (4, 4, 4)
# cycles of each simulator mode's sweep at 4x4x8, cut from 1200 for the
# time limit (the CUDA, CPU and dense runs of six modes: ~105 s at 1200;
# 600 until PR 28); 500 keep both of the phased mode's phases (300 + 200)
SIM_MODES_CYCLES = 500
# the PT 8^3 fault sweep's cycles, warm-up and fault cycle, cut from 6000,
# 2000 and 3000 for the time limit (its two sweeps: 45-59 s at 6000, 24.4
# s at 3000 until PR 28)
FAULT_SWEEP_CYCLES, FAULT_SWEEP_WARMUP, FAULT_SWEEP_T_FAULT = 1500, 500, 750
# the chaos campaign's arrivals at PDTT 8^3, cut from the reference's 20
# for the time limit (its campaign: 83-104 s at 20, 66.1 s at 10 on a slow
# host); seed 7's 6 still bring a storm of 4, a degraded disconnection, 2
# restores and a full heal (16 events, 22 at 10: phase_chaos on the CPU)
CHAOS_ARRIVALS = 6
# the chaos replay's arrivals a campaign at PDTT 4^3, cut from 20 for the
# time limit (two campaigns: ~52 s at 20, 26-41 s at 10, 22.3 s at 5 with
# the build, 18.4 s at 3 on a slow host)
CHAOS_REPLAY_ARRIVALS = 2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_counts(so: str, ops=("HGMMA", "UTMALDG", "SYNCS", "USETMAXREG",
                               "STL", "LDL"), by_function=False) -> dict:
    """Instructions of a built library by opcode (``cuobjdump -sass``), in
    all or (``by_function``) per kernel. The default opcodes: wgmma
    (HGMMA), TMA loads (UTMALDG), mbarrier ops (SYNCS), register hand-over
    (USETMAXREG) and local-memory spills (STL, LDL); the minplus library
    adds FADD, FMNMX, DPX add-min (VIADDMNMX) and cp.async (LDGSTS)."""
    from repro_torch.kernels import nvcc
    tool = Path(nvcc.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", so], capture_output=True,
                          text=True, timeout=120, check=True).stdout

    def count(text):
        return {op: len(re.findall(rf"\b{op}\b", text)) for op in ops}
    if not by_function:
        return count(sass)
    return {sec.splitlines()[0].strip(): count(sec)
            for sec in sass.split("Function : ")[1:]}


def minplus_bound_ms(M: int, K: int, N: int, ops_per_s: float) -> tuple:
    """Least time for one f32 (min,+) product: M*N*K adds and M*N*K mins,
    which do not fuse, at one FP32 instruction per lane per clock
    (``ops_per_s``), or each operand read once and the result written
    once at the memory rate; the larger, and which one it is."""
    t_ops = 2.0 * M * N * K / ops_per_s * 1e3
    t_bytes = 4.0 * (M * K + K * N + M * N) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hops_bound_ms(M: int, K: int, N: int, dpx_per_s: float) -> tuple:
    """Least time for one hop-path product: M*N*K / 2 VIADDMNMX.s16x2
    instructions (two triples each) at the rate the probe measured on
    this card (``dpx_per_s``), or int16 operands read once and the
    result written once at the memory rate; the larger, and which."""
    t_ops = 0.5 * M * N * K / dpx_per_s * 1e3
    t_bytes = 2.0 * (M * K + K * N + M * N) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class SmiSampler:
    """``nvidia-smi`` sampling the SM clock and power draw every 20 ms
    while the ``with`` block runs; ``summary()`` gives the least, median
    and largest of each."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        self.out = self.proc.communicate(timeout=30)[0]

    def summary(self) -> dict:
        rows = []
        for line in self.out.splitlines():
            try:
                clock, power = (float(x) for x in line.split(","))
            except ValueError:          # "[N/A]", or a line cut short
                continue
            rows.append((clock, power))
        if not rows:
            return dict(samples=0)
        clock, power = (sorted(c) for c in zip(*rows))
        return dict(samples=len(rows), sm_clock_mhz=[clock[0],
                    clock[len(clock) // 2], clock[-1]],
                    power_w=[power[0], power[len(power) // 2], power[-1]])


def phase_minplus_build(mp, nvcc):
    """The minplus library's ptxas report (no spills) and its SASS by
    kernel: FADD + FMNMX in the f32 path, VIADDMNMX in the hop path."""
    log = nvcc.LOGS.get("minplus", "")
    ptxas = [line.strip() for line in log.splitlines()
             if "Used" in line or "spill" in line]
    spills = [int(x) for line in ptxas for x in re.findall(
        r"(\d+) bytes spill (?:stores|loads)", line)]
    counts = sass_counts(mp.library()._name,
                         ("FADD", "FMNMX", "VIADDMNMX", "LDGSTS", "STL",
                          "LDL"), by_function=True)
    kernels = {k: v for k, v in counts.items() if "minplus_kernel" in k}
    # minplus_probe_kernel<op>: what each probed instruction compiles to
    probes = {op: next(v for k, v in counts.items()
                       if f"minplus_probe_kernelILi{i}E" in k)
              for i, op in enumerate(mp.PROBE_OPS)}
    emit(phase="minplus_build", ptxas=ptxas, sass_by_kernel=kernels,
         sass_by_probe=probes)
    check(probes["fadd"]["FADD"] and probes["fmin"]["FMNMX"]
          and probes["viaddmin_s32"]["VIADDMNMX"]
          and probes["viaddmin_s16x2"]["VIADDMNMX"],
          f"probed instructions compile to other opcodes: {probes}")
    check(ptxas and spills and not any(spills),
          f"minplus kernels spill or report nothing: {ptxas}")
    hop = [v for k, v in kernels.items() if "HopPath" in k]
    f32 = [v for k, v in kernels.items() if "F32Path" in k]
    check(len(hop) == 2 and all(v["VIADDMNMX"] > 0 and v["FMNMX"] == 0
                                and v["LDGSTS"] > 0 for v in hop),
          f"hop kernels are not VIADDMNMX fed by cp.async: {hop}")
    check(len(f32) == 2 and all(v["FADD"] > 0 and v["FMNMX"] > 0
                                for v in f32), f"f32 kernels: {f32}")
    check(not any(v["STL"] or v["LDL"] for v in kernels.values()),
          "minplus kernels use local memory")


def phase_minplus_probe(mp, sm_clock_hz, sms):
    """Issue rates of the instructions the two paths are built from, per
    SM per clock (``minplus.probe``), and what each path's inner step
    does per clock: the f32 pair one triple per FADD + FMNMX, s32 one per
    instruction, s16x2 two. Returns the s16x2 instruction rate of the
    card, in instructions per second."""
    rates = {op: mp.probe(op) for op in mp.PROBE_OPS}
    triples = {"f32_pair": rates["f32_add_min_pair"]["median"],
               "s32": rates["viaddmin_s32"]["median"],
               "s16x2": 2 * rates["viaddmin_s16x2"]["median"]}
    emit(phase="minplus_probe", per_sm_per_clock=rates,
         triples_per_sm_per_clock=triples, hop_path="s16x2")
    check(all(r["sms"] == sms for r in rates.values()),
          "the probe did not reach every SM")
    check(triples["s16x2"] > max(triples["s32"], triples["f32_pair"]),
          f"s16x2 is not the fastest form: {triples}")
    return rates["viaddmin_s16x2"]["median"] * sms * sm_clock_hz


def phase_kernels(mp, ops, ref, PT, tons, ops_per_s, dpx_per_s):
    """Both minplus paths against their plain versions on the card, the
    main path's APSPs against the host BFS, and each path timed at the
    main path's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(M, K, N):
        return (torch.rand(M, K, device=dev, generator=g) * 10,
                torch.rand(K, N, device=dev, generator=g) * 10)

    def rand_hops(M, K, N, hi):
        return tuple(torch.randint(0, hi + 1, s, device=dev, generator=g,
                                   dtype=torch.int16) for s in ((M, K), (K, N)))

    # the main path's inputs: the hop matrices of PT 8^3 (512^3 products)
    # and TONS_SYM 256 (256^3), and their partial closures; PT 8x8x16's
    # closure for ragged blocks; random f32 at every shape, and a shape
    # with ragged edges on every side
    pt8_h, t256_h, pt8x16_h = (ops.hop_matrix(t.edges(), t.n, dev) for t in
                               (PT.pt((8, 8, 8)), tons, PT.pt((8, 8, 16))))
    pt8, t256 = ops.decode_hops(pt8_h), ops.decode_hops(t256_h)
    closure = ref.apsp_ref(ops.decode_hops(pt8x16_h))

    def partial(d, squarings):
        for _ in range(squarings):
            d = ref.minplus_ref(d, d)
        return d

    cases = [
        ((128, 128, 128), "random", *rand(128, 128, 128)),
        ((128, 128, 128), "hops", pt8[:128, :128].contiguous(),
         pt8[:128, :128].contiguous()),
        ((512, 512, 512), "random", *rand(512, 512, 512)),
        ((512, 512, 512), "hops", pt8, partial(pt8, 3)),
        ((256, 256, 256), "random", *rand(256, 256, 256)),
        ((256, 256, 256), "hops", t256, partial(t256, 3)),
        ((1024, 256, 512), "random", *rand(1024, 256, 512)),
        ((1024, 256, 512), "hops", closure[:, :256].contiguous(),
         closure[:256, :512].contiguous()),
        ((100, 70, 130), "random", *rand(100, 70, 130)),
        # the 128 x 128-word tile, whole and with ragged edges
        ((2048, 64, 2048), "random", *rand(2048, 64, 2048)),
        ((2050, 100, 2046), "random", *rand(2050, 100, 2046)),
    ]
    max_err = 0.0
    for (M, K, N), kind, x, y in cases:
        got = mp.minplus(x, y)
        torch.cuda.synchronize()
        want = ref.minplus_ref(x, y)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"minplus {kind} {(M, K, N)} differs, max err {err}")
        emit(phase="minplus_parity", path="f32", shape=[M, K, N],
             input=kind, exact=True, max_abs_err=err,
             plan=mp.plan("f32", M, N, K))

    # the hop path: the same hop matrices and closures encoded, held to
    # the plain int16 version and, mapped back, to the f32 kernel
    enc = ops.encode_hops
    hop_cases = [
        ((512, 512, 512), "hops", pt8_h, pt8_h),
        ((512, 512, 512), "hops", pt8_h, enc(partial(pt8, 3))),
        ((256, 256, 256), "hops", t256_h, t256_h),
        ((256, 256, 256), "hops", t256_h, enc(partial(t256, 3))),
        ((1024, 256, 512), "hops", enc(closure)[:, :256].contiguous(),
         enc(closure)[:256, :512].contiguous()),
        ((100, 70, 130), "random", *rand_hops(100, 70, 130, ops.HOP_INF)),
        ((511, 513, 257), "random", *rand_hops(511, 513, 257, 100)),
        ((512, 512, 512), "random", *rand_hops(512, 512, 512, ops.HOP_INF)),
        ((256, 256, 256), "random", *rand_hops(256, 256, 256, 40)),
        ((4096, 128, 4096), "random", *rand_hops(4096, 128, 4096, 200)),
    ]
    hop_err = 0
    for (M, K, N), kind, x, y in hop_cases:
        got = mp.minplus_hops(x, y)
        torch.cuda.synchronize()
        want = ref.minplus_hops_ref(x, y)
        err = int((got.int() - want.int()).abs().max())
        hop_err = max(hop_err, err)
        check(torch.equal(got, want),
              f"minplus_hops {kind} {(M, K, N)} differs, max err {err}")
        line = dict(phase="minplus_parity", path="hops", shape=[M, K, N],
                    input=kind, exact=True, max_abs_err=err,
                    plan=mp.plan("hops", M, N, K))
        if kind == "hops":
            f32 = mp.minplus(ops.decode_hops(x), ops.decode_hops(y))
            check(torch.equal(ops.decode_hops(got), f32),
                  f"hop and f32 kernels differ at {(M, K, N)}")
            line["equals_f32_kernel"] = True
        emit(**line)

    # the main path's APSP of each fabric equals the host BFS
    for name, topo in (("PT 8x8x8", PT.pt((8, 8, 8))), ("TONS_SYM 256", tons)):
        check(np.array_equal(PT.bfs_all_pairs(topo, device=dev),
                             PT.bfs_all_pairs(topo,
                                              sources=np.arange(topo.n))),
              f"{name} APSP differs from host BFS")
        stats: dict = {}
        ops.apsp(ops.hop_matrix(topo.edges(), topo.n, dev), stats)
        emit(phase="apsp_parity", fabric=name, n=topo.n,
             equal_to_host_bfs=True, squarings_run=stats["squarings"],
             squarings_reference=int(math.ceil(math.log2(topo.n - 1))),
             path=stats["path"])

    # each path timed at the main path's shapes, on the main path's own
    # hop matrices: CUDA events over back-to-back calls of the counted
    # wrapper the main path calls (host dispatch and, on the hop path,
    # the range check's reduction and host read included), the same of
    # the bare launch, and the kernel's device time from a profiler
    # trace; the SM clock sampled where a call is long enough to show it
    rows = {"f32": {}, "hops": {}}

    def time_row(path, n, h, reps, plain_reps):
        f = ops.decode_hops(h)
        if path == "f32":
            call = lambda: mp.minplus(f, f)                    # noqa: E731
            launch = lambda: mp.run(f, f)                      # noqa: E731
            plain = lambda: ref.minplus_ref(f, f)              # noqa: E731
            bound, by = minplus_bound_ms(n, n, n, ops_per_s)
        else:
            call = lambda: mp.minplus_hops(h, h)               # noqa: E731
            launch = lambda: mp.run(h, h, entry="minplus_hops")  # noqa: E731
            plain = lambda: ref.minplus_hops_ref(h, h)         # noqa: E731
            bound, by = hops_bound_ms(n, n, n, dpx_per_s)
        row = dict(ms=cuda_ms(call, reps),
                   unchecked_ms=cuda_ms(launch, reps))
        card = None
        if n >= 4096:
            with SmiSampler() as smi_log:
                row.update(device_ms(launch, reps, "minplus_kernel"))
            card = smi_log.summary()
        else:
            row.update(device_ms(launch, reps, "minplus_kernel"))
        row.update(plain_ms=cuda_ms(plain, plain_reps), bound_ms=bound,
                   bound_by=by)
        rows[path][n] = row
        emit(phase="minplus_time", path=path, shape=[n, n, n],
             bound_share=bound_share(bound, row),
             plan=mp.plan(path, n, n, n), card=card, **row)

    for n, h in ((512, pt8_h), (256, t256_h)):
        for path in ("f32", "hops"):
            time_row(path, n, h, 50, 5)

    # the full TPU v4 pod: PT 16^3, n = 4096, on the hop path
    topo = PT.pt((16, 16, 16))
    mp.hop_launches = 0
    t0 = time.perf_counter()
    d_dev = PT.bfs_all_pairs(topo, device=dev)
    torch.cuda.synchronize()
    t_apsp = time.perf_counter() - t0
    apsp_launches = mp.hop_launches
    t0 = time.perf_counter()
    d_host = PT.bfs_all_pairs(topo, sources=np.arange(topo.n))
    t_bfs = time.perf_counter() - t0
    check(np.array_equal(d_dev, d_host), "16^3 APSP differs from host BFS")
    diam, avg = ops.topology_metrics(topo.edges(), topo.n, device=dev)
    fin = d_host[np.isfinite(d_host)]
    check(diam == int(fin.max()), "16^3 diameter differs from host BFS")
    # bfs_all_pairs's steps, each timed to a synchronise
    split, stats = {}, {}
    t0 = time.perf_counter()
    d0 = ops.hop_matrix(topo.edges(), topo.n, dev)
    torch.cuda.synchronize()
    split["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = ops.apsp(d0, stats)
    torch.cuda.synchronize()
    split["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = d.cpu()
    split["to_host_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = d.numpy().astype(np.float64)
    d[d >= ops.UNREACHABLE] = np.inf
    split["host_convert_s"] = time.perf_counter() - t0
    check(np.array_equal(d, d_host), "16^3 APSP steps differ from host BFS")
    reference = int(math.ceil(math.log2(topo.n - 1)))
    check(stats["path"] == "hops" and stats["squarings"] < reference
          and apsp_launches == stats["squarings"],
          f"16^3 APSP ran {stats} in {apsp_launches} hop launches against "
          f"the reference's {reference} squarings")
    for path in ("f32", "hops"):
        time_row(path, 4096, d0, 20, 1)
    emit(phase="apsp_16x16x16", n=topo.n, equal_to_host_bfs=True,
         diameter=diam, avg_hops=avg, squarings_run=stats["squarings"],
         hop_launches=apsp_launches,
         squarings_reference=reference, apsp_s=t_apsp, apsp_split=split,
         host_bfs_s=t_bfs,
         ms_per_squaring={p: rows[p][4096]["device_ms"] for p in rows},
         bound_ms_per_squaring={p: rows[p][4096]["bound_ms"] for p in rows},
         bound_by={"f32": "operations at the FP32 rate",
                   "hops": "operations at the probe's VIADDMNMX rate"})
    return rows, max_err, hop_err


def serve_prompts(vocab: int):
    """The serving phase's 8 prompts: lengths 128-1024 and tokens from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, SERVE_REQUESTS)
    return [rng.integers(0, vocab, int(n)) for n in lens]


def flash_bound_ms(B, Hq, Hkv, Sq, Skv, hd, itemsize, causal,
                   flops_per_s) -> tuple:
    """Least time for one attention: 4 * hd flops per visible (q, k) pair
    (top-left causal: row i sees min(i + 1, Skv) keys) at the dense BF16
    tensor-core rate, or q, k, v read once and o written once at the
    memory rate; the larger, and which one it is."""
    if causal:
        n = min(Sq, Skv)
        pairs = n * (n + 1) // 2 + max(Sq - Skv, 0) * Skv
    else:
        pairs = Sq * Skv
    t_ops = 4.0 * B * Hq * hd * pairs / flops_per_s * 1e3
    t_bytes = itemsize * hd * B * (2 * Hq * Sq + 2 * Hkv * Skv) \
        / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _attn_inputs(g, B, Hq, Hkv, Sq, Skv, hd, dtype, model_layout=False):
    """Normal q, k, v on the generator's device; with ``model_layout`` as
    the serving path hands them over: (B, S, H, hd) activations viewed as
    (B, H, S, hd)."""
    dev = g.device

    def one(H, S):
        if model_layout:
            return torch.randn((B, S, H, hd), generator=g, device=dev,
                               dtype=torch.float32).to(dtype).transpose(1, 2)
        return torch.randn((B, H, S, hd), generator=g, device=dev,
                           dtype=torch.float32).to(dtype)
    return one(Hq, Sq), one(Hkv, Skv), one(Hkv, Skv)


def row_rel_err(got, want) -> float:
    """The largest over rows of max|got - want| / max|want|: the error
    held to the size of the row it is in. At S = 32768 a typical output
    lies below the 2e-2 atol, so allclose alone would pass late rows
    that are moderately wrong."""
    g, w = got.float(), want.float()
    return float(((g - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp_min(1e-30)).max())


def phase_flash(fa, ref, prompt_lens, family_lens, flops_per_s,
                dev="cuda"):
    """The flash kernel against its plain version at test_kernels.py's
    sweep, the non-causal and Sq < Skv cases (f32 on the CUDA-core
    kernel, bf16 on the tensor-core one) at every head dim it takes, the
    serving shapes (the serve phase's prompt lengths among them) at hd
    128 and 64, the other families' head geometries at their prompt
    lengths (gemma-7b's at hd 256 and stablelm-12b's at hd 160 in both
    dtypes), and S = 32768 with one head and at the serving heads in the
    model's layout; then timed at the serving shapes from S = 142 to
    32768, and at gemma's and stablelm's from 2048 to 8192
    (``FLASH_TIME``), beside PyTorch's SDPA, and the plain version where
    it fits. Each case passes allclose at the dtype's tolerance, and in
    bf16 also :func:`row_rel_err` at that tolerance. Returns the timed
    rows by head dim and S, and the largest error by dtype."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((1, Hq, Hkv, S, S, hd), dt, True, False)
             for S in (128, 256) for hd in fa.HEAD_DIMS
             for Hq, Hkv in ((4, 4), (4, 2), (8, 1)) for dt in (f32, bf16)]
    cases += [((2, 4, 2, 128, 256, hd), dt, False, False)
              for hd in fa.HEAD_DIMS for dt in (f32, bf16)]
    cases += [((1, 4, 2, 128, 256, hd), dt, True, False)
              for hd in fa.HEAD_DIMS for dt in (f32, bf16)]
    cases += [((1, 16, 2, S, S, 128), bf16, True, True)
              for S in sorted({100, 512, 1000, 2048, *prompt_lens})]
    cases += [((1, 16, 2, S, S, 64), bf16, True, True) for S in (142, 891)]
    # the other families' prefill geometries at their prompt lengths:
    # deepseek (16/16, hd 128), jamba (32/8, hd 128) and seamless (16/16,
    # hd 64: the encoder and cross attention non-causal, the decoder causal)
    cases += [((1, Hq, Hkv, S, S, hd), bf16, causal, True)
              for S in family_lens
              for Hq, Hkv, hd, causal in ((16, 16, 128, True),
                                          (32, 8, 128, True),
                                          (16, 16, 64, True),
                                          (16, 16, 64, False))]
    # gemma-7b (16/16, hd 256) and stablelm-12b (32/8, hd 160) likewise,
    # in both dtypes
    cases += [((1, Hq, Hkv, S, S, hd), dt, True, True)
              for S in family_lens for Hq, Hkv, hd in ((16, 16, 256),
                                                       (32, 8, 160))
              for dt in (f32, bf16)]
    cases += [((1, 1, 1, LONG_S, LONG_S, 128), bf16, True, False),
              ((1, 16, 2, LONG_S, LONG_S, 128), bf16, True, True)]
    max_err = {f32: 0.0, bf16: 0.0}
    for shape, dt, causal, layout in cases:
        _, Hq, Hkv, Sq, _, _ = shape
        q, k, v = _attn_inputs(g, *shape, dt, model_layout=layout)
        got = fa.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        # the plain version's f32 scores take 13 GB per query head at
        # LONG_S: compare one query head (and its kv head) at a time there
        rep = Hq // Hkv
        heads = ([(slice(h, h + 1), slice(h // rep, h // rep + 1))
                  for h in range(Hq)] if Sq >= LONG_S
                 else [(slice(None), slice(None))])
        tol, err, row_err, close = FLASH_TOL[dt], 0.0, 0.0, True
        for hq, hkv in heads:
            want = ref.flash_attention_ref(q[:, hq], k[:, hkv], v[:, hkv],
                                           causal)
            part = got[:, hq]
            err = max(err, float((part.float() - want.float()).abs().max()))
            row_err = max(row_err, row_rel_err(part, want))
            close &= torch.allclose(part.float(), want.float(), rtol=tol,
                                    atol=tol)
            del want
        max_err[dt] = max(max_err[dt], err)
        check(got.dtype == dt and got.shape == q.shape and close
              and (dt != bf16 or row_err <= tol),
              f"flash {shape} {dt} causal={causal} differs, max err {err}, "
              f"row-relative {row_err}")
        emit(phase="flash_parity", shape=list(shape), dtype=str(dt),
             causal=causal, model_layout=layout, max_abs_err=err,
             row_rel_err=row_err, tol=tol)
        del q, k, v, got
    torch.cuda.empty_cache()

    rows = {}
    for hd, (Hq, Hkv, sizes) in FLASH_TIME.items():
        rows[hd] = {}
        for S in sizes:
            q, k, v = _attn_inputs(g, 1, Hq, Hkv, S, S, hd, bf16,
                                   model_layout=True)
            reps = 20 if S <= 8192 else 5
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, True), reps)
            # the plain version's (Hq, S, S) f32 scores: 4.3 GB at S =
            # 8192 and 16 heads, 69 GB at 32768, which does not fit
            # beside its copies
            plain_ms = cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, True), 3) if S <= 8192 else None
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps)
            # the bound counts the function's hd (160, not the padded 192)
            bound, by = flash_bound_ms(1, Hq, Hkv, S, S, hd, 2, True,
                                       flops_per_s)
            rows[hd][S] = dict(ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=bound,
                               bound_by=by)
            emit(phase="flash_time", shape=[1, Hq, Hkv, S, S, hd],
                 dtype="bfloat16", causal=True, launches_timed=reps,
                 vs_library=ms / library_ms, bound_share=bound / ms,
                 **rows[hd][S])
            del q, k, v
            torch.cuda.empty_cache()
    return rows, max_err


def phase_serve(fa, PM, Request, Server, cfg, dev="cuda"):
    """The serving main path at full width: random weights from seed 0 on
    the card, 8 ragged requests through ``Server.run``."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = PM.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_max_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()          # the serving footprint
    n_params = sum(p.numel() for p in params.parameters())
    param_gb = sum(p.numel() * p.element_size()
                   for p in params.parameters()) / 1e9
    server = Server(cfg, params, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                    device=dev)
    reqs = [Request(i, p, SERVE_MAX_NEW)
            for i, p in enumerate(serve_prompts(cfg.vocab))]

    prefill_s, decode_ms, finite = [], [], []
    prefill_one, decode = server._prefill_one, server._decode

    def timed_prefill(slot, req):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill_one(slot, req)            # ends in a host read of the token
        prefill_s.append(time.perf_counter() - t)

    def timed_decode(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = decode(*a)
        finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        return logits, caches

    server._prefill_one, server._decode = timed_prefill, timed_decode
    fa.launches = 0                                   # the main path
    t0 = time.perf_counter()
    out = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    tokens = sum(len(v) for v in out["results"].values())
    all_finite = bool(torch.stack(finite).all())
    emit(phase="serve", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
         prompt_lens=[len(r.prompt) for r in reqs], max_new=SERVE_MAX_NEW,
         served=out["served"], decode_steps=out["decode_steps"],
         tokens=tokens, wall_s=wall, prefill_s=sum(prefill_s),
         prefill_s_each=prefill_s,
         decode_ms_median=float(np.median(decode_ms)),
         tok_per_s=tokens / wall, flash_launches=launches,
         init_s=init_s, init_max_memory_gb=init_max_gb,
         n_params=n_params, param_gb=param_gb,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         decode_logits_finite=all_finite)
    check(out["served"] == SERVE_REQUESTS,
          f"served {out['served']} of {SERVE_REQUESTS}")
    check(all(len(v) == SERVE_MAX_NEW + 1 and
              all(0 <= t < cfg.vocab for t in v)
              for v in out["results"].values()), "token streams malformed")
    check(launches == cfg.n_layers * SERVE_REQUESTS,
          f"flash launches {launches}, want {cfg.n_layers} x "
          f"{SERVE_REQUESTS}")
    check(all_finite, "non-finite decode logits")

    # where a step's time goes: one prefill of the longest prompt and 3
    # decode steps under the profiler, after the main path's count
    longest = max(reqs, key=lambda r: len(r.prompt))
    tokens_in = torch.as_tensor(longest.prompt, device=dev)[None, :]
    pos = int(server.pos.max())
    with torch.inference_mode():
        pre = busy_share(lambda: PM.prefill_fn(
            cfg, params, {"tokens": tokens_in}, cache_len=SERVE_MAX_LEN),
            by_kernel=True)
        dec = busy_share(lambda: decode(params, server.caches,
                                        server.tokens, pos), reps=3)
    emit(phase="serve_profile", prefill_tokens=len(longest.prompt),
         prefill=pre, decode_steps=3, decode=dec,
         decode_kernels_per_step=dec["kernels"] / 3,
         decode_ms_per_step=dec["wall_s"] / 3 * 1e3)
    return launches, params


def phase_prefill_long(fa, PM, cfg, params, dev="cuda"):
    """One prefill of a LONG_S-token prompt (tokens from ``default_rng(0)``)
    at full width through ``prefill_fn``: seconds of the first call,
    peak memory, then busy share and device time by kernel under the
    profiler (after its own warm-up). Returns the first call's flash
    launches."""
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, LONG_S)),
                             device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    with torch.inference_mode():
        fa.launches = 0                                  # the long prefill
        t0 = time.perf_counter()
        logits, caches = PM.prefill_fn(cfg, params, {"tokens": tokens})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = fa.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finite = bool(torch.isfinite(logits).all())
        shapes = [list(logits.shape), list(caches["k"].shape)]
        del logits, caches
        prof = busy_share(lambda: PM.prefill_fn(cfg, params,
                                                {"tokens": tokens}),
                          by_kernel=True)
    emit(phase="prefill_long", arch=cfg.name, n_layers=cfg.n_layers,
         prompt_tokens=LONG_S, first_s=first_s, flash_launches=launches,
         max_memory_gb=peak_gb, resident_gb_before=base_gb,
         logits_finite=finite, logits_shape=shapes[0],
         cache_shape=shapes[1], tokens_per_s=LONG_S / first_s, **prof)
    check(finite, "non-finite logits from the long prefill")
    check(shapes == [[1, 1, cfg.vocab], [cfg.n_layers, 1, LONG_S,
                                         cfg.n_kv_heads, cfg.head_dim]],
          f"long prefill shapes {shapes}")
    check(launches == cfg.n_layers,
          f"long prefill launched flash {launches} times, want "
          f"{cfg.n_layers}")
    return launches


def phase_serve_cpu_vs_gpu(PM, cfg, dev="cuda"):
    """One set of weights at full width, depth 2: prefill of a ragged
    100-token prompt and 3 teacher-forced decode steps on the CPU (plain
    attention) and on CUDA (the kernel); logits agree within the stated
    bf16 tolerance."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    cpu = PM.init_params(cfg2, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 104)))
    S = 100
    errs, agree = [], []
    with torch.inference_mode():
        outs = []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            t = toks.to(d)
            logits, caches = PM.prefill_fn(cfg2, model,
                                           {"tokens": t[:, :S]},
                                           cache_len=104)
            steps = [logits]
            for i in range(3):
                logits, caches = PM.decode_fn(cfg2, model, caches,
                                              t[:, S + i:S + i + 1], S + i)
                steps.append(logits)
            outs.append([x.float().cpu() for x in steps])
    for c, g in zip(*outs):
        errs.append(float((c - g).abs().max()))
        agree.append(int(c.argmax()) == int(g.argmax()))
        check(torch.allclose(g, c, rtol=MODEL_RTOL, atol=MODEL_ATOL),
              f"CPU and CUDA logits differ by {errs[-1]}")
    emit(phase="serve_cpu_vs_gpu", arch=cfg.name, n_layers=2,
         prompt_len=S, decode_steps=3, max_abs_err=errs,
         argmax_agree=agree, rtol=MODEL_RTOL, atol=MODEL_ATOL,
         logit_abs_max=float(outs[0][0].abs().max()))


def family_config(get_config, arch, cuts=FAMILY_LAYERS):
    """An arch's published config, cut in depth where ``cuts`` says."""
    cfg = get_config(arch).model
    if arch in cuts:
        cfg = dataclasses.replace(cfg, n_layers=cuts[arch])
    return cfg


def attention_layers(cfg) -> int:
    """Flash launches of one prefill: each attention layer; for an
    encoder-decoder the encoder's layers and the decoder's self and
    cross attention."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers
    return sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))


def prefill_batch(cfg, prompt, dev, frames=None, patches=None):
    """``prefill_fn``'s batch for one prompt; an encoder-decoder takes
    ``frames`` (zeros of the prompt's length, as the Server feeds), a
    vision arch ``patches`` where given (the Server gives none)."""
    tokens = torch.as_tensor(prompt, device=dev)[None, :]
    if cfg.family != "encdec":
        if patches is None:
            return {"tokens": tokens}
        return {"tokens": tokens, "patches": patches}
    if frames is None:
        frames = torch.zeros((1, tokens.shape[1], cfg.d_model),
                             dtype=torch.bfloat16, device=dev)
    return {"tokens": tokens, "frames": frames}


def _route_log(L, log, follow=None):
    """Patch ``L.moe_route`` to log each call's experts (T, K) sorted,
    and its router probabilities, on the host; with ``follow`` (an
    earlier log) the i-th call takes the i-th logged experts instead,
    through ``L.moe_assign`` with its own probabilities. Returns the
    original."""
    orig = L.moe_route
    calls = iter(follow or ())

    def route(p, xf, cfg, C):
        r = orig(p, xf, cfg, C)
        if follow is not None:
            r = L.moe_assign(r.probs, next(calls)[0].to(r.eidx.device), C)
        log.append((r.eidx.sort(dim=1).values.cpu(),
                    r.probs.detach().float().cpu()))
        return r
    L.moe_route = route
    return orig


def phase_serve_family(fa, PM, L, Request, Server, cfg, dev="cuda"):
    """Another family's serving path at its published widths: random
    weights from seed 0 on the card, the first FAMILY_REQUESTS of the
    serve prompts (4 slots, so two are refilled), FAMILY_MAX_NEW tokens
    each, through ``Server.run`` twice, each on a fresh Server: both serve
    every request with the same token streams (the MoE combine sums in a
    fixed order), and the first launches flash once per attention layer
    and prefill. Then one prefill of the longest prompt and one decode
    step under the profiler, with the device time of the MoE's or the
    SSD's functions. Returns the first run's flash launches."""
    gc.collect()             # a Server and its wrapped methods form a cycle
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = PM.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = sum(p.numel() * p.element_size()
                   for p in params.parameters()) / 1e9
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.reset_peak_memory_stats()
    prompts = serve_prompts(cfg.vocab)[:FAMILY_REQUESTS]
    want = attention_layers(cfg) * FAMILY_REQUESTS
    runs = []
    for _ in range(2):
        # the first run's Server (a cycle through its wrapped methods) and
        # its cache go before the second's: qwen1.5-32b's cut holds 62 GB
        # of weights and 9.4 GB of cache, no room for two caches
        server = prefill_one = None
        gc.collect()
        torch.cuda.empty_cache()
        server = Server(cfg, params, n_slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, device=dev)
        reqs = [Request(i, p, FAMILY_MAX_NEW) for i, p in enumerate(prompts)]
        prefill_s, decode_ms, finite = [], [], []
        prefill_one, decode = server._prefill_one, server._decode

        def timed_prefill(slot, req):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill_one(slot, req)
            prefill_s.append(time.perf_counter() - t)

        def timed_decode(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = decode(*a)
            finite.append(torch.isfinite(logits).all())
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t) * 1e3)
            return logits, caches

        server._prefill_one, server._decode = timed_prefill, timed_decode
        fa.launches = 0                              # this path, this run
        t0 = time.perf_counter()
        out = server.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(v) for v in out["results"].values())
        runs.append(dict(
            out=out, launches=fa.launches, wall_s=wall, tokens=tokens,
            prefill_s=sum(prefill_s), prefill_s_each=prefill_s,
            decode_ms_median=float(np.median(decode_ms)),
            tok_per_s=tokens / wall,
            finite=bool(torch.stack(finite).all())))
    first, second = runs
    out = first["out"]
    same = first["out"]["results"] == second["out"]["results"]
    emit(phase="serve_family", arch=cfg.name, family=cfg.family,
         n_layers=cfg.n_layers, enc_layers=cfg.enc_layers,
         dec_layers=cfg.dec_layers, d_model=cfg.d_model,
         slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
         prompt_lens=[len(p) for p in prompts], max_new=FAMILY_MAX_NEW,
         served=out["served"], decode_steps=out["decode_steps"],
         **{k: first[k] for k in ("tokens", "wall_s", "prefill_s",
                                  "prefill_s_each", "decode_ms_median",
                                  "tok_per_s")},
         second_run={k: second[k] for k in ("wall_s", "prefill_s",
                                            "decode_ms_median",
                                            "tok_per_s")},
         flash_launches=first["launches"], flash_launches_want=want,
         streams_equal_across_runs=same, init_s=init_s, n_params=n_params,
         param_gb=param_gb,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         decode_logits_finite=first["finite"] and second["finite"])
    for r in runs:
        check(r["out"]["served"] == FAMILY_REQUESTS,
              f"{cfg.name}: served {r['out']['served']} of "
              f"{FAMILY_REQUESTS}")
        check(all(len(v) == FAMILY_MAX_NEW + 1 and
                  all(0 <= t < cfg.vocab for t in v)
                  for v in r["out"]["results"].values()),
              f"{cfg.name}: token streams malformed")
        check(r["finite"], f"{cfg.name}: non-finite decode logits")
    check(first["launches"] == want,
          f"{cfg.name}: flash launches {first['launches']}, want {want}")
    check(same, f"{cfg.name}: two runs of the same requests gave other "
          "token streams")

    # where the time goes: one prefill of the longest prompt and one
    # decode step, with the device time of the MoE's or the SSD's parts
    names = {"moe": FAMILY_TAGS["moe"], "ssm": FAMILY_TAGS["ssm"],
             "hybrid": FAMILY_TAGS["moe"] + FAMILY_TAGS["ssm"]
             }.get(cfg.family, ())
    batch = prefill_batch(cfg, max(prompts, key=len), dev)
    pos = int(server.pos.max())
    with torch.inference_mode(), tagged(L, names):
        pre = busy_share(lambda: PM.prefill_fn(cfg, params, batch,
                                               cache_len=SERVE_MAX_LEN),
                         by_kernel=True, tags=names)
        dec = busy_share(lambda: decode(params, server.caches,
                                        server.tokens, pos),
                         by_kernel=True, tags=names)
    shares = {}
    for name, prof in (("prefill", pre), ("decode", dec)) if names else ():
        ms, total = prof["tag_device_ms"], prof["device_ms"]
        if total:                  # a trace may hold no kernel (timing.py)
            shares[name] = {k: v / total for k, v in ms.items()}
            shares[name]["total"] = sum(ms.values()) / total
    emit(phase="serve_family_profile", arch=cfg.name,
         prefill_tokens=int(batch["tokens"].shape[1]), prefill=pre,
         decode=dec, decode_kernels_per_step=dec["kernels"],
         decode_ms_per_step=dec["wall_s"] * 1e3,
         device_share_by_function=shares)
    return first["launches"]


def family_check_config(get_config, cfg):
    """The CPU-vs-CUDA check's cut of a family: depth 2 at full width
    (an MoE model's dense first layer and an MoE layer; two Mamba
    layers), one encoder and one decoder layer at full width, and for a
    hybrid one super-block at ``smoke_model()`` widths (a full-width one
    is 26.5 GB in host memory)."""
    if cfg.family == "hybrid":
        return get_config(cfg.name).smoke_model()
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, enc_layers=1, dec_layers=1,
                                   n_layers=2)
    return dataclasses.replace(cfg, n_layers=2)


def phase_serve_family_cpu_vs_gpu(PM, L, get_config, cfg, dev="cuda"):
    """One set of weights (:func:`family_check_config`): prefill of a
    100-token prompt (an encoder-decoder's with 100 normal frames; a
    vision arch's of ``n_vision_tokens`` tokens with that many normal
    patch embeddings, which the Server does not feed) and 3
    teacher-forced decode steps on the CPU (plain attention) and on CUDA
    (the kernel); logits agree within the stated bf16 tolerance. Where
    the two devices route a token to other experts, the line and the
    check say so."""
    cfg2 = family_check_config(get_config, cfg)
    gpu = PM.init_params(cfg2, seed=0, device=dev)
    cpu = copy.deepcopy(gpu).to("cpu")
    S = max(100, cfg2.n_vision_tokens)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg2.vocab, (1, S + 4)))
    frames = torch.as_tensor(rng.standard_normal(
        (1, S, cfg2.d_model)).astype(np.float32)).to(torch.bfloat16)
    patches = torch.as_tensor(rng.standard_normal(
        (1, cfg2.n_vision_tokens, cfg2.d_model)).astype(np.float32)) \
        if cfg2.n_vision_tokens else None
    routes = {}
    outs = []
    with torch.inference_mode():
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            routes[d] = []
            orig_route = _route_log(L, routes[d])
            try:
                t = toks.to(d)
                logits, caches = PM.prefill_fn(
                    cfg2, model, prefill_batch(
                        cfg2, t[0, :S], d, frames.to(d),
                        None if patches is None else patches.to(d)),
                    cache_len=S + 4)
                steps = [logits]
                for i in range(3):
                    logits, caches = PM.decode_fn(
                        cfg2, model, caches, t[:, S + i:S + i + 1], S + i)
                    steps.append(logits)
            finally:
                L.moe_route = orig_route
            outs.append([x.float().cpu() for x in steps])
    other = [{"call": i, "tokens": torch.nonzero((a != b).any(1)).flatten()
              .tolist()} for i, ((a, _), (b, _)) in enumerate(zip(
                  routes["cpu"], routes[dev])) if not torch.equal(a, b)]
    errs = [float((c - g).abs().max()) for c, g in zip(*outs)]
    agree = [int(c.argmax()) == int(g.argmax()) for c, g in zip(*outs)]
    emit(phase="serve_family_cpu_vs_gpu", arch=cfg.name,
         cut=dict(n_layers=cfg2.n_layers, enc_layers=cfg2.enc_layers,
                  dec_layers=cfg2.dec_layers, d_model=cfg2.d_model),
         prompt_len=S, patches=None if patches is None
         else list(patches.shape), decode_steps=3, max_abs_err=errs,
         argmax_agree=agree, moe_calls=len(routes["cpu"]),
         expert_choice_differs=other, rtol=MODEL_RTOL, atol=MODEL_ATOL,
         logit_abs_max=float(outs[0][0].abs().max()))
    for c, g, err in zip(*outs, errs):
        check(torch.allclose(g, c, rtol=MODEL_RTOL, atol=MODEL_ATOL),
              f"{cfg.name}: CPU and CUDA logits differ by {err}; experts "
              f"chosen otherwise on the two devices: {other or 'none'}")


# ---------------------------------------------------------------------------
# The training path (ROADMAP item 10): the dense family, qwen2.5-3b
# ---------------------------------------------------------------------------


def train_flops_per_token(cfg, n_params: int, S: int) -> float:
    """Model flops of one token of a training step, forward and backward
    (remat's recompute not counted): 6 N for the weights' matmuls, where
    N is every parameter but an untied embedding (a lookup; a tied one is
    the head's V x D matmul and counts once) and an MoE's unchosen
    experts (``param_count - active_param_count``: the top_k experts of
    each token count), plus 12 Hq hd S for the attention scores and P.V
    over all S positions in each attention layer (encoder-decoder: the
    encoder's, the decoder's and its cross attention; the blocked
    attention computes every block, the masked ones too). A Mamba
    layer's SSD counts only through its projections."""
    N = n_params - (0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model) \
        - (cfg.param_count() - cfg.active_param_count())
    return 6.0 * N + 12.0 * attention_layers(cfg) * cfg.n_heads * \
        cfg.head_dim * S


def train_config(cfg, steps, ckpt_dir, lr, warmup, total, batch, seq, dev,
                 log_every=100):
    """A ``Trainer`` of ``cfg`` from seed 0 for ``steps`` steps of a
    schedule of ``total``, checkpointing at the last, as
    ``launch/train.py`` builds it (with its ``extra_inputs``)."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch.train import extra_inputs
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import TrainConfig, Trainer
    return Trainer(cfg, DataConfig(cfg.vocab, seq, batch),
                   OptConfig(lr=lr, total_steps=total, warmup_steps=warmup),
                   TrainConfig(steps=steps, ckpt_dir=str(ckpt_dir),
                               ckpt_every=steps, log_every=log_every),
                   seed=0, extra_batch=extra_inputs(cfg, batch, seq, dev),
                   device=dev)


def phase_train_full(fa, cfg, bf16_flops_per_s, dev="cuda"):
    """The training main path at full width: ``Trainer.run`` with the
    launcher's defaults (batch 4, seq 128, lr 3e-4, warmup max(steps //
    10, 5)) for TRAIN_STEPS steps, an async checkpoint at the last step
    into a temporary directory (removed afterwards); then one more step
    under the profiler. Returns (the trainer, flash launches)."""
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        gc.collect()
        torch.cuda.empty_cache()
        resident_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = train_config(cfg, TRAIN_STEPS, ckpt_dir, TRAIN_LR,
                          max(TRAIN_STEPS // 10, 5), TRAIN_STEPS,
                          TRAIN_BATCH, TRAIN_SEQ, dev, log_every=1)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        state_gb = torch.cuda.memory_allocated() / 1e9
        n_params = sum(p.numel() for p in tr.model.parameters())
        free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
        calls, save = [], tr.ckpt.save

        def timed_save(step, state, blocking=False):
            calls.append(time.time())
            save(step, state, blocking)
        tr.ckpt.save = timed_save
        fa.launches = 0                               # the training path
        out = tr.run()
        launches = fa.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        final = ckpt_dir / f"step-{TRAIN_STEPS}"
        manifest = json.loads((final / "manifest.json").read_text())
        save_s = manifest["time"] - calls[0]
        ckpt_gb = sum(f.stat().st_size for f in final.iterdir()) / 1e9
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    batch = tr.data.torch_batch(TRAIN_STEPS, dev)
    prof = busy_share(lambda: tr.step_fn(tr.model, tr.opt_state, batch))
    launches = fa.launches                  # the run and the profiled steps
    losses = out["losses"]
    med = statistics.median(out["step_times"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fpt = train_flops_per_token(cfg, n_params, TRAIN_SEQ)
    emit(phase="train_full", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_params=n_params, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=TRAIN_LR,
         warmup=max(TRAIN_STEPS // 10, 5), remat=cfg.remat,
         attn_block=cfg.attn_block, losses=losses,
         step_times_s=out["step_times"], median_step_s_after_first=med,
         tokens_per_s=tokens / med, flops_per_token=fpt,
         flops_formula="6 N + 12 L Hq hd S a token (N parameters, the "
                       "tied embedding once), remat's recompute not counted",
         model_tflops_per_s=fpt * tokens / med / 1e12,
         bf16_peak_share=fpt * tokens / med / bf16_flops_per_s,
         init_s=init_s, resident_gb_before=resident_gb,
         state_gb=state_gb, max_memory_gb=peak_gb,
         flash_launches=launches, stragglers=out["stragglers"],
         kernels_per_step=prof["kernels"], busy_share=prof["busy_share"],
         profiled_step_s=prof["wall_s"], device_busy_s=prof["device_busy_s"],
         free_disk_gb_before_save=free_gb, save_s=save_s,
         checkpoint_gb=ckpt_gb, checkpoint_leaves=manifest["n_leaves"])
    check(out["final_step"] == TRAIN_STEPS,
          f"trained {out['final_step']} of {TRAIN_STEPS} steps")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check((losses[-1] + losses[-2]) / 2 < losses[0],
          f"the loss did not fall: {losses}")
    check(launches == 0, f"training launched the flash kernel {launches} "
          "times")
    return tr, launches, losses, dict(
        max_memory_gb=peak_gb, median_step_s_after_first=med,
        kernels_per_step=prof["kernels"], busy_share=prof["busy_share"],
        profiled_step_s=prof["wall_s"])


def phase_train_long(fa, tr, cfg, bf16_flops_per_s, dev="cuda"):
    """One training step of the full-width model at train_4k's sequence
    length (B 1, S TRAIN_LONG_S), after train_full: seconds and peak
    memory of the first step, then a profiled step; and the blocked
    attention's share of it, from one layer's attention timed alone
    (forward, and the remat's forward again with the backward) times the
    layers. Returns the flash launches and the figures of the long step
    (its first loss among them)."""
    from repro_torch.models import layers as L
    batch = long_batch(cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    fa.launches = 0                                   # the long step
    t0 = time.perf_counter()
    loss = float(tr.step_fn(tr.model, tr.opt_state, batch)["loss"])
    first_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = busy_share(lambda: tr.step_fn(tr.model, tr.opt_state, batch))
    launches = fa.launches

    g = torch.Generator(device=dev).manual_seed(0)
    S, hd = TRAIN_LONG_S, cfg.head_dim

    def rand(H):
        return torch.randn((1, S, H, hd), generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_(True)
    q, k, v = rand(cfg.n_heads), rand(cfg.n_kv_heads), rand(cfg.n_kv_heads)
    ct = torch.randn(q.shape, generator=g, device=dev, dtype=torch.bfloat16)

    def attn():
        return L.blocked_attention(q, k, v, causal=True,
                                   block=cfg.attn_block)

    def attn_fwd_bwd():
        torch.autograd.grad(attn(), (q, k, v), ct)
    with torch.no_grad():
        fwd_ms = cuda_ms(attn, 3)
    fwd_bwd_ms = cuda_ms(attn_fwd_bwd, 3)
    attn_step_ms = cfg.n_layers * (fwd_ms + fwd_bwd_ms)
    fpt = train_flops_per_token(
        cfg, sum(p.numel() for p in tr.model.parameters()), TRAIN_LONG_S)
    flops_per_s = fpt * TRAIN_LONG_S / prof["wall_s"]
    emit(phase="train_long", arch=cfg.name, n_layers=cfg.n_layers, batch=1,
         seq=TRAIN_LONG_S, attn_block=cfg.attn_block, remat=cfg.remat,
         loss=loss, first_step_s=first_s, max_memory_gb=peak_gb,
         resident_gb_before=base_gb, profiled_step_s=prof["wall_s"],
         device_busy_s=prof["device_busy_s"], busy_share=prof["busy_share"],
         kernels_per_step=prof["kernels"], flash_launches=launches,
         tokens_per_s=TRAIN_LONG_S / prof["wall_s"], flops_per_token=fpt,
         model_tflops_per_s=flops_per_s / 1e12,
         bf16_peak_share=flops_per_s / bf16_flops_per_s,
         attn_layer_fwd_ms=fwd_ms, attn_layer_fwd_bwd_ms=fwd_bwd_ms,
         attn_ms_per_step=attn_step_ms,
         attn_share_of_device_time=attn_step_ms / 1e3 /
         prof["device_busy_s"])
    check(math.isfinite(loss), f"long step loss {loss}")
    check(launches == 0, f"the long step launched flash {launches} times")
    return launches, dict(loss=loss, first_step_s=first_s,
                          max_memory_gb=peak_gb,
                          profiled_step_s=prof["wall_s"],
                          kernels_per_step=prof["kernels"],
                          busy_share=prof["busy_share"])


def long_batch(cfg, dev):
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(cfg.vocab, TRAIN_LONG_S, 1)).torch_batch(
        0, dev)


def phase_remat_dots(fa, cfg, plain_params, plain_full, plain_long,
                     train_losses, bf16_flops_per_s, dev="cuda"):
    """train_full's and train_long's steps once more, in the same order
    from the same seed, with ``cfg.opt_remat_dots``: the body layers keep
    the outputs of their 2-D products (``lm.save_dots``) and recompute
    the rest. TRAIN_STEPS steps through ``Trainer.run`` (checkpoints
    off), train_full's profiled step on batch TRAIN_STEPS, then
    train_long's first and profiled steps at S TRAIN_LONG_S. The losses
    and the final parameters must equal the plain-remat run's
    (``plain_params``, host copies) bit for bit; peak memory, step s,
    kernels a step and busy share beside the plain run's figures
    (``plain_full``, ``plain_long``). Returns the flash launches."""
    t0 = time.perf_counter()
    dcfg = dataclasses.replace(cfg, opt_remat_dots=True)
    gc.collect()
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remat_") as d:
        tr = train_config(dcfg, TRAIN_STEPS, d, TRAIN_LR,
                          max(TRAIN_STEPS // 10, 5), TRAIN_STEPS,
                          TRAIN_BATCH, TRAIN_SEQ, dev)
        tr.ckpt.save = lambda *a, **kw: None
        fa.launches = 0                             # the remat_dots path
        out = tr.run()
    short_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = tr.data.torch_batch(TRAIN_STEPS, dev)
    prof = busy_share(lambda: tr.step_fn(tr.model, tr.opt_state, batch))
    batch = long_batch(cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    long_loss = float(tr.step_fn(tr.model, tr.opt_state, batch)["loss"])
    long_first_s = time.perf_counter() - t1
    long_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    long_prof = busy_share(lambda: tr.step_fn(tr.model, tr.opt_state,
                                              batch))
    launches = fa.launches
    params = dict(tr.model.named_parameters())
    differ = [n for n, p in params.items()
              if not torch.equal(p.detach().cpu(), plain_params[n])]
    del tr, params
    gc.collect()
    torch.cuda.empty_cache()
    med = statistics.median(out["step_times"][1:])
    short = dict(max_memory_gb=short_peak_gb, median_step_s_after_first=med,
                 kernels_per_step=prof["kernels"],
                 busy_share=prof["busy_share"], profiled_step_s=prof["wall_s"])
    long = dict(loss=long_loss, first_step_s=long_first_s,
                max_memory_gb=long_peak_gb,
                profiled_step_s=long_prof["wall_s"],
                kernels_per_step=long_prof["kernels"],
                busy_share=long_prof["busy_share"])
    emit(phase="remat_dots", arch=cfg.name, n_layers=cfg.n_layers,
         policy="save aten.mm / aten.addmm outputs, recompute the rest",
         resident_gb_before=resident_gb, losses=out["losses"],
         plain_losses=train_losses, step_times_s=out["step_times"],
         train_full=short, train_full_plain=plain_full,
         train_long=long, train_long_plain=plain_long,
         delta_peak_gb=dict(
             train_full=short_peak_gb - plain_full["max_memory_gb"],
             train_long=long_peak_gb - plain_long["max_memory_gb"]),
         params_differing=differ[:8], n_params_differing=len(differ),
         flash_launches=launches, seconds=time.perf_counter() - t0)
    check(out["losses"] == train_losses, f"remat_dots losses "
          f"{out['losses']} are not plain remat's {train_losses}")
    check(long_loss == plain_long["loss"], f"remat_dots long-step loss "
          f"{long_loss} is not plain remat's {plain_long['loss']}")
    check(not differ, f"{len(differ)} parameters differ from plain remat's "
          f"after the same steps: {differ[:8]}")
    check(launches == 0, f"remat_dots launched flash {launches} times")
    return launches


def phase_train_cpu_vs_gpu(get_config, dev="cuda"):
    """The smoke config's weights (seed 0, made on the CPU) trained 3
    steps on the CPU and on CUDA with ``make_step`` on identical batches
    (B 4, S 32, lr 1e-3, warmup 1), once at each of TRAIN_MICROBATCHES:
    losses within TRAIN_LOSS_RTOL and the parameters within
    TRAIN_PARAM_REL over all leaves, the CPU tests' tolerances for the
    port against the reference at this config."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.models import model as PM
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainConfig, make_step
    cfg = get_config(TRAIN_ARCH).smoke_model()
    init = PM.init_params(cfg, seed=0, device="cpu")
    data = SyntheticLM(DataConfig(cfg.vocab, 32, 4))
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for mb in TRAIN_MICROBATCHES:
        cpu = copy.deepcopy(init)
        gpu = copy.deepcopy(init).to(dev)
        losses = {}
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            model.requires_grad_(True)
            step = make_step(cfg, oc, TrainConfig(microbatches=mb))
            state = adamw.init(dict(model.named_parameters()))
            losses[d] = [float(step(model, state, data.torch_batch(s, d))
                               ["loss"]) for s in range(3)]
        num = den = 0.0
        for (name, c), (_, gp) in zip(cpu.named_parameters(),
                                      gpu.named_parameters()):
            c, gp = c.detach().float(), gp.detach().float().cpu()
            num += float(((gp - c) ** 2).sum())
            den += float((c ** 2).sum())
        param_rel = math.sqrt(num / den)
        loss_rel = [abs(a - b) / abs(a) for a, b in zip(losses["cpu"],
                                                       losses[dev])]
        emit(phase="train_cpu_vs_gpu", arch=cfg.name, cut="smoke_model",
             microbatches=mb, steps=3, losses_cpu=losses["cpu"],
             losses_cuda=losses[dev], loss_rel_err=loss_rel,
             param_rel_err=param_rel, loss_rtol=TRAIN_LOSS_RTOL,
             param_rel_bound=TRAIN_PARAM_REL)
        check(max(loss_rel) <= TRAIN_LOSS_RTOL,
              f"CPU and CUDA losses differ at {mb} microbatches: {losses}")
        check(param_rel <= TRAIN_PARAM_REL,
              f"CPU and CUDA parameters differ by {param_rel} after 3 steps "
              f"at {mb} microbatches")


def phase_train_resume(get_config, dev="cuda", arch=TRAIN_ARCH,
                       phase="train_resume"):
    """``arch``'s smoke config on the card: 4 steps straight, again, and
    2 steps, a checkpoint, a new ``Trainer`` and 2 more. Parameters,
    moments and step equal bit for bit in all three, losses too."""
    cfg = get_config(arch).smoke_model()

    def snapshot(tr):
        out = [p.detach().clone() for p in tr.model.parameters()]
        for key in ("m", "v"):
            out += [t.clone() for t in tr.opt_state[key].values()]
        return out + [tr.opt_state["step"].clone()]

    def trainer(d, steps):
        return train_config(cfg, steps, d, 1e-3, 1, 4, 4, 32, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as root:
        root = Path(root)
        runs, losses = [], []
        for name in ("a", "b"):
            tr = trainer(root / name, 4)
            losses.append(tr.run()["losses"])
            runs.append(snapshot(tr))
        first = trainer(root / "c", 2)
        split = first.run()["losses"]
        second = trainer(root / "c", 4)
        resumed_from = second.start_step
        losses.append(split + second.run()["losses"])
        runs.append(snapshot(second))
    same = [all(torch.equal(x, y) for x, y in zip(runs[0], r))
            for r in runs[1:]]
    emit(phase=phase, arch=cfg.name, cut="smoke_model", steps=4,
         resumed_from=resumed_from, losses=losses, leaves=len(runs[0]),
         rerun_equal=same[0], resume_equal=same[1],
         losses_equal=losses[0] == losses[1] == losses[2])
    check(resumed_from == 2, f"resumed from step {resumed_from}, not 2")
    check(all(same), f"runs differ (rerun, resume): {same}")
    check(losses[0] == losses[1] == losses[2], f"losses differ: {losses}")


def phase_train_family_full(fa, PM, cfg, bf16_flops_per_s, dev="cuda"):
    """Another family's training at full width (TRAIN_FAMILY_LAYERS'
    cuts): ``Trainer.run`` with the launcher's defaults for TRAIN_STEPS
    steps (TRAIN_FAMILY_STEPS where the arch names another count) from
    seed 0 at S TRAIN_SEQ (or TRAIN_FAMILY_SEQ's), weights made on the
    card, its checkpoint saves turned off (resume is held at smoke
    width); then one more step under
    the profiler. An arch of TRAIN_GRAD_ONLY instead takes one forward
    and backward of ``model.loss_fn`` through ``torch.autograd.grad``,
    timed, then one under the profiler, and no optimizer. Returns the
    flash launches and the step's figures."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch.train import extra_inputs
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    grad_only = cfg.name in TRAIN_GRAD_ONLY
    seq = TRAIN_FAMILY_SEQ.get(cfg.name, TRAIN_SEQ)
    steps = TRAIN_FAMILY_STEPS.get(cfg.name, TRAIN_STEPS)
    warmup = max(steps // 10, 5)
    fa.launches = 0                                  # this arch's training
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_family_") as d:
        if grad_only:
            model = PM.init_params(cfg, seed=0, device=dev)
            model.requires_grad_(True)
        else:
            tr = train_config(cfg, steps, d, TRAIN_LR, warmup, steps,
                              TRAIN_BATCH, seq, dev, log_every=1)
            model = tr.model
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        state_gb = torch.cuda.memory_allocated() / 1e9
        n_params = sum(p.numel() for p in model.parameters())
        if grad_only:
            params = list(model.parameters())
            batch = SyntheticLM(DataConfig(cfg.vocab, seq,
                                           TRAIN_BATCH)).torch_batch(0, dev)

            def step():
                loss = PM.loss_fn(cfg, model, batch)
                grads = torch.autograd.grad(loss, params)
                finite = torch.stack([torch.isfinite(g).all()
                                      for g in grads]).all()
                return loss.detach(), finite
            t0 = time.perf_counter()
            loss, finite = step()
            losses, finite = [float(loss)], bool(finite)
            step_times = [time.perf_counter() - t0]
            norms, saves = [], []
            prof = busy_share(step)
        else:
            norms, saves, step_fn = [], [], tr.step_fn

            def recorded(*a):
                stats = step_fn(*a)
                norms.append(float(stats["grad_norm"]))
                return stats
            tr.step_fn = recorded
            tr.ckpt.save = lambda step, *a, **kw: saves.append(step)
            out = tr.run()
            losses, step_times = out["losses"], out["step_times"]
            finite = all(math.isfinite(x) for x in losses + norms)
            extra = extra_inputs(cfg, TRAIN_BATCH, seq, dev)
            batch = tr.data.torch_batch(
                steps, dev, extra(steps) if extra else None)
            prof = busy_share(lambda: step_fn(tr.model, tr.opt_state, batch))
    launches = fa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(step_times[1:]) if len(step_times) > 1 \
        else prof["wall_s"]
    tokens = TRAIN_BATCH * seq
    fpt = train_flops_per_token(cfg, n_params, seq)
    emit(phase="train_family_full", arch=cfg.name, family=cfg.family,
         n_layers=cfg.n_layers, enc_layers=cfg.enc_layers,
         dec_layers=cfg.dec_layers, d_model=cfg.d_model, n_params=n_params,
         optimizer=not grad_only, batch=TRAIN_BATCH, seq=seq,
         steps=len(losses), lr=TRAIN_LR, warmup=warmup,
         remat=cfg.remat, losses=losses, grad_norms=norms,
         step_times_s=step_times, median_step_s_after_first=step_s,
         tokens_per_s=tokens / step_s, flops_per_token=fpt,
         flops_formula="6 N + 12 L_attn Hq hd S a token (N parameters but "
                       "an untied embedding and the unchosen experts; "
                       "L_attn attention layers), remat's recompute and "
                       "the SSD's own products not counted",
         model_tflops_per_s=fpt * tokens / step_s / 1e12,
         bf16_peak_share=fpt * tokens / step_s / bf16_flops_per_s,
         init_s=init_s, resident_gb_before=resident_gb, state_gb=state_gb,
         max_memory_gb=peak_gb, flash_launches=launches,
         checkpoint_saves_skipped=saves, kernels_per_step=prof["kernels"],
         busy_share=prof["busy_share"], profiled_step_s=prof["wall_s"],
         device_busy_s=prof["device_busy_s"], all_finite=finite)
    check(finite, f"{cfg.name}: non-finite loss, grad norm or gradient: "
          f"{losses} {norms}")
    if not grad_only:
        check(len(losses) == steps,
              f"{cfg.name}: trained {len(losses)} of {steps} steps")
        check(losses[-1] < losses[0],
              f"{cfg.name}: the loss did not fall: {losses}")
    check(launches == 0, f"{cfg.name}: training launched the flash kernel "
          f"{launches} times")
    return launches, {"losses": losses,
                      "median_step_s_after_first": step_s,
                      "tokens_per_s": tokens / step_s,
                      "kernels_per_step": prof["kernels"],
                      "busy_share": prof["busy_share"],
                      "max_memory_gb": peak_gb}


def phase_train_family_cpu_vs_gpu(get_config, L, dev="cuda"):
    """Each family arch's smoke config (seed 0, made on the CPU) trained 3
    steps on the CPU and on CUDA with ``make_step`` on identical batches
    (B 4, S 32, lr 1e-3, warmup 1; frames from ``extra_inputs``): losses
    within TRAIN_LOSS_RTOL and the parameters within the arch's
    TRAIN_FAMILY_PARAM_REL, the CPU tests' bounds against the reference.
    An MoE arch logs every routing call on both devices; a parameter gap
    over the bound passes only where the first call routed otherwise
    does so at near ties of the CPU's probabilities (gap < NEAR_TIE),
    and the run that follows the CPU's experts on CUDA (always printed)
    is within it."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch.train import extra_inputs
    from repro_torch.models import model as PM
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainConfig, make_step
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for arch in TRAIN_FAMILY_ARCHS:
        cfg = get_config(arch).smoke_model()
        init = PM.init_params(cfg, seed=0, device="cpu")
        data = SyntheticLM(DataConfig(cfg.vocab, 32, 4))

        def train(d, log, follow=None):
            model = copy.deepcopy(init).to(d).requires_grad_(True)
            extra = extra_inputs(cfg, 4, 32, d)
            step = make_step(cfg, oc, TrainConfig())
            state = adamw.init(dict(model.named_parameters()))
            orig = _route_log(L, log, follow)
            try:
                losses = [float(step(model, state, data.torch_batch(
                    s, d, extra(s) if extra else None))["loss"])
                    for s in range(3)]
            finally:
                L.moe_route = orig
            return model, losses

        def gaps(model, losses):
            num = den = 0.0
            for (_, c), (_, g) in zip(cpu.named_parameters(),
                                      model.named_parameters()):
                c, g = c.detach().float(), g.detach().float().cpu()
                num += float(((g - c) ** 2).sum())
                den += float((c ** 2).sum())
            return ([abs(a - b) / abs(a) for a, b in zip(cpu_losses,
                                                        losses)],
                    math.sqrt(num / den))
        logs = {"cpu": [], dev: [], "follow": []}
        cpu, cpu_losses = train("cpu", logs["cpu"])
        gpu, gpu_losses = train(dev, logs[dev])
        loss_rel, param_rel = gaps(gpu, gpu_losses)
        first = None
        for i, ((a, probs), (b, _)) in enumerate(zip(logs["cpu"],
                                                     logs[dev])):
            if not torch.equal(a, b):
                top = probs.sort(dim=1, descending=True).values
                gap = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
                toks = torch.nonzero((a != b).any(1)).flatten()
                first = {"call": i, "tokens": toks.tolist(),
                         "prob_gap": gap[toks].tolist(),
                         "near_tie": bool((gap[toks] < NEAR_TIE).all())}
                break
        followed = None
        if cfg.n_experts:
            fmodel, flosses = train(dev, logs["follow"], logs["cpu"])
            followed = dict(zip(("loss_rel_err", "param_rel_err"),
                                gaps(fmodel, flosses)))
        bound = TRAIN_FAMILY_PARAM_REL[arch]
        emit(phase="train_family_cpu_vs_gpu", arch=arch, cut="smoke_model",
             steps=3, losses_cpu=cpu_losses, losses_cuda=gpu_losses,
             loss_rel_err=loss_rel, param_rel_err=param_rel,
             moe_calls=len(logs["cpu"]), first_routing_difference=first,
             following_cpu_experts=followed, loss_rtol=TRAIN_LOSS_RTOL,
             param_rel_bound=bound)
        check(len(logs["cpu"]) == len(logs[dev]),
              f"{arch}: {len(logs['cpu'])} MoE calls on the CPU, "
              f"{len(logs[dev])} on CUDA")
        if followed is not None:
            check(followed["param_rel_err"] <= bound and
                  max(followed["loss_rel_err"]) <= TRAIN_LOSS_RTOL,
                  f"{arch}: following the CPU's experts, CUDA is "
                  f"{followed} from the CPU")
        if param_rel > bound or max(loss_rel) > TRAIN_LOSS_RTOL:
            check(first is not None and first["near_tie"],
                  f"{arch}: CPU and CUDA differ by {param_rel} (losses "
                  f"{loss_rel}) without a routing near tie: {first}")


def phase_ssd_grad_128(L, dev="cuda"):
    """The SSD alone at mamba2's head shapes (B 1, S 128, H 80, P 64,
    one group of N 128) and its default chunk of 128, dt in the init's
    range [0.001, 0.1] and A from -1 to -16: the gradient of a random
    projection of y and the final state on CUDA, every input's finite
    and within SSD_GRAD_REL of the CPU's; and the count of non-finite
    entries of the unmasked ``exp(ddec)`` form's gradient (caveat R9)."""
    g = torch.Generator().manual_seed(0)
    S, H, P, N = 128, 80, 64, 128
    ins = [torch.randn((1, S, H, P), generator=g),
           torch.rand((1, S, H), generator=g) * 0.099 + 0.001,
           -torch.linspace(1.0, 16.0, H),
           torch.randn((1, S, 1, N), generator=g),
           torch.randn((1, S, 1, N), generator=g)]
    cts = [torch.randn((1, S, H, P), generator=g),
           torch.randn((1, H, P, N), generator=g)]

    def grads(d):
        ts = [t.to(d).requires_grad_(True) for t in ins]
        y, st = L.ssd_chunked(*ts, 128)
        loss = (y * cts[0].to(d)).sum() + (st * cts[1].to(d)).sum()
        return [x.cpu() for x in torch.autograd.grad(loss, ts)]
    cpu, gpu = grads("cpu"), grads(dev)
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(gpu, cpu)]
    finite = all(bool(torch.isfinite(x).all()) for x in gpu)
    masked = L._intra_decay
    L._intra_decay = lambda ddec, tri: torch.exp(ddec)
    try:
        unmasked_bad = sum(int((~torch.isfinite(x)).sum())
                           for x in grads(dev))
    finally:
        L._intra_decay = masked
    emit(phase="ssd_grad_128", shape=[1, S, H, P, N], chunk=128,
         inputs=["xh", "dt", "A", "Bm", "Cm"], grad_rel_err_cuda_vs_cpu=rel,
         bound=SSD_GRAD_REL, finite=finite,
         unmasked_nonfinite_grad_entries=unmasked_bad)
    check(finite, "the SSD's gradient at chunk 128 is not finite on CUDA")
    check(max(rel) <= SSD_GRAD_REL,
          f"the SSD's CUDA gradient is {rel} from the CPU's")


def drive(name, topo, PNS, route_pod):
    """route_pod + saturation_point at the defaults, on the card."""
    t0 = time.perf_counter()
    rp = route_pod(topo, device="cuda")
    t_route = time.perf_counter() - t0
    check(rp.unreachable == 0, f"{name}: unreachable pairs")
    stats: dict = {}
    t0 = time.perf_counter()
    sat, trace = PNS.saturation_point(rp.tables, stats=stats,
                                      device="cuda")
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    for r in trace:
        check(r["injected_total"] == r["consumed_total"] + r["in_flight"],
              f"{name}: conservation fails at rate {r['rate']}")
        check(r["delivered_tagged"] <= r["accepted"] <= r["offered"]
              + 1e-12, f"{name}: accounting order at rate {r['rate']}")
    check(0.0 < sat <= 1.0, f"{name}: saturation {sat}")
    emit(phase="main_path", fabric=name, n=topo.n, saturation=sat,
         route_s=t_route, sweep_s=t_sweep, l_max=rp.l_max,
         route_timings=rp.timings, sim_cycles=stats["sim_cycles"],
         lane_cycles=stats["lane_cycles"],
         sim_cycles_per_s=stats["sim_cycles"] / t_sweep,
         lane_cycles_per_s=stats["lane_cycles"] / t_sweep,
         trace_rates=[r["rate"] for r in trace], conservation=True)
    return rp


def _conserving(trace) -> bool:
    return all(r["injected_total"] == r["consumed_total"] + r["in_flight"]
               and all(t["injected"] == t["consumed"] + t["in_flight"]
                       for t in r.get("tenants", {}).values())
               for r in trace)


# the live reference's 8^3 hotspot saturations at the acceptance config
# (test_netsim_adaptive.py: K=4, local_search_rounds=1), JAX 0.9.0; the
# port's CPU run of phase_fault_sweep's cell gives the same values
HOTSPOT_SAT = {"static": 0.0336015625, "adaptive": 0.033916015625}


def _escape_config(PipelineConfig, **kw):
    """The adaptive suite's routing: robust allowed turns at 4 VCs, VC 0
    kept free for the escape lane."""
    return PipelineConfig(n_vc=4, priority="robust", reserve_escape=True,
                          **kw)


def phase_sim_modes(PNS, PT, PF, TR, route_pod, PipelineConfig,
                    dims=(4, 4, 8), cycles=SIM_MODES_CYCLES, dev="cuda"):
    """Every simulator mode beyond the static path on the card, held to
    the same sweep on the CPU (``==``), and the dense oracle kernel to
    the CSR kernel on the card: adaptive, static and adaptive with an
    OCS fault a third of the way in, bursty, phased and two-tenant
    traffic, at 4 rates."""
    topo = PT.pt(dims)
    rp = route_pod(topo, _escape_config(PipelineConfig, K=4,
                                        local_search_rounds=1), device=dev)
    ev = PF.fault_event(rp.at, PF.colors_in_use(topo)[0], cycles // 3)
    spec = PNS.adaptive_spec(topo, dead_channels=ev[1])
    n = topo.n
    rng = np.random.default_rng(0)
    jobs = (np.arange(n // 2), np.arange(n // 2 - 8, n - 8))
    modes = {
        "adaptive": dict(adaptive=spec),
        "static_fault": dict(fault=ev),
        "adaptive_fault": dict(adaptive=spec, fault=ev),
        "bursty": dict(traffic=TR.TrafficPattern.uniform(n).with_burst(
            64, duty=0.25, gain=3.0)),
        "phased": dict(traffic=TR.PhasedTraffic("trace", (
            TR.TrafficPattern.uniform(n),
            TR.TrafficPattern.hotspot(n, frac=0.4)), (300, 200))),
        "tenants": dict(traffic=TR.compose_tenants(n, [
            TR.TenantSpec(f"job{k}", v, rng.random((len(v),) * 2), share)
            for k, (v, share) in enumerate(zip(jobs, (1.0, 0.5)))])),
    }
    rates = [0.02, 0.08, 0.2, 0.6]
    kw = dict(cycles=cycles, warmup=cycles // 3)
    threads = torch.get_num_threads()
    for name, mode in modes.items():
        times = {}
        runs = {}
        for key, d, kernel in (("cuda", dev, "csr"), ("cpu", "cpu", "csr"),
                               ("dense", dev, "dense")):
            # the CPU run is many small ops: intra-op threads only add
            # overhead there
            torch.set_num_threads(1 if key == "cpu" else threads)
            t0 = time.perf_counter()
            runs[key] = PNS.sweep(rp.tables, rates, kernel=kernel, device=d,
                                  **kw, **mode)
            times[f"{key}_s"] = time.perf_counter() - t0
        torch.set_num_threads(threads)
        got = runs["cuda"]
        emit(phase="sim_modes_determinism", fabric=f"PT {dims}", mode=name,
             rates=rates, cycles=cycles, equal_to_cpu=got == runs["cpu"],
             dense_equals_csr=runs["dense"] == got,
             delivered=[r["delivered"] for r in got],
             escaped=[r["escaped"] for r in got],
             in_flight=[r["in_flight"] for r in got],
             stalled_at=[r["stalled_at"] for r in got],
             tenants=[r.get("tenants") for r in got], **times)
        check(got == runs["cpu"], f"{name}: CUDA and CPU sweeps differ")
        check(runs["dense"] == got, f"{name}: dense and CSR kernels differ")
        check(_conserving(got), f"{name}: conservation fails")


def phase_fault_sweep(PNS, PT, PF, TR, route_pod, PipelineConfig,
                      dims=(8, 8, 8), cycles=FAULT_SWEEP_CYCLES,
                      warmup=FAULT_SWEEP_WARMUP,
                      t_fault=FAULT_SWEEP_T_FAULT, prof_cycles=256,
                      sat=dict(step=0.005, max_rate=0.08, cycles=1500,
                               warmup=500), dev="cuda", profile=None):
    """The first OCS colour dies at ``t_fault`` under static and adaptive
    routing (5 rates); packets are conserved in every lane. Then kernels
    per cycle and busy share of the faulted sweep under the profiler, and
    saturation under an 8-endpoint hotspot, adaptive not below static,
    each equal to the live reference's value (HOTSPOT_SAT). The routing
    is the reference's acceptance config (test_netsim_adaptive.py's
    ``_build``, as in phase_sim_modes)."""
    topo = PT.pt(dims)
    t0 = time.perf_counter()
    rp = route_pod(topo, _escape_config(PipelineConfig, K=4,
                                        local_search_rounds=1), device=dev)
    route_s = time.perf_counter() - t0
    check(rp.unreachable == 0, "fault_sweep: unreachable pairs")
    color = PF.colors_in_use(topo)[0]
    ev = PF.fault_event(rp.at, color, t_fault)
    t0 = time.perf_counter()
    spec = PNS.adaptive_spec(topo, dead_channels=ev[1])
    spec_s = time.perf_counter() - t0
    rates = [0.05, 0.10, 0.15, 0.20, 0.25]
    modes = {"static": {}, "adaptive": dict(adaptive=spec)}
    for name, mode in modes.items():
        stats: dict = {}
        t0 = time.perf_counter()
        tr = PNS.sweep(rp.tables, rates, cycles=cycles, warmup=warmup,
                       fault=ev, stats=stats, device=dev, **mode)
        sweep_s = time.perf_counter() - t0
        emit(phase="fault_sweep", fabric=f"PT {dims}", mode=name,
             color=color, dead_channels=len(ev[1]), t_fault=t_fault,
             cycles=cycles, warmup=warmup, route_s=route_s,
             route_timings=rp.timings, spec_s=spec_s, sweep_s=sweep_s,
             cycles_run=stats["cycles_run"],
             cycles_per_s=stats["cycles_run"] / sweep_s,
             lane_cycles_per_s=stats["lane_cycles"] / sweep_s,
             per_rate=[{k: r[k] for k in (
                 "rate", "delivered", "in_flight", "escaped", "stalled_at",
                 "injected_total", "consumed_total")} for r in tr],
             conservation=_conserving(tr))
        check(_conserving(tr), f"fault_sweep {name}: conservation fails")
    profile = profile or busy_share
    for name, mode in modes.items():
        prof = profile(lambda: PNS.sweep(
            rp.tables, rates, cycles=prof_cycles, warmup=prof_cycles // 2,
            fault=(prof_cycles // 2, ev[1]), device=dev, **mode))
        emit(phase="fault_sweep_profile", fabric=f"PT {dims}", mode=name,
             lanes=len(rates), cycles=prof_cycles,
             kernels_per_cycle=prof["kernels"] / prof_cycles, **prof)
    tp = TR.TrafficPattern.hotspot(topo.n, list(range(8)), 0.4)
    sats, secs = {}, {}
    for name, mode in modes.items():
        t0 = time.perf_counter()
        sats[name], trace = PNS.saturation_point(rp.tables, traffic=tp,
                                                 device=dev, **sat, **mode)
        secs[name] = time.perf_counter() - t0
        check(_conserving(trace), f"hotspot {name}: conservation fails")
    emit(phase="fault_sweep_hotspot", fabric=f"PT {dims}", hot_nodes=8,
         frac=0.4, saturation=sats, saturation_s=secs, **sat)
    check(sats["adaptive"] >= sats["static"] and sats["adaptive"] > 0,
          f"adaptive saturation below static under hotspot: {sats}")
    check(dims != (8, 8, 8) or sats == HOTSPOT_SAT,
          f"hotspot saturations {sats} differ from the reference's "
          f"{HOTSPOT_SAT}")


def phase_repair(PR, PF, PT, mp, dims=REPAIR_DIMS, dev="cuda"):
    """Time to recover: the cold serving build of PDTT ``dims`` (its APL
    hop matrix on the minplus hop kernel), then an incremental repair of
    the first OCS colour, fully verified."""
    topo = PT.pdtt(dims)
    launches0 = mp.hop_launches
    t0 = time.perf_counter()
    st = PR.ServingState.build(topo, n_vc=2, K=4, seed=0, robust=True,
                               device=dev)
    build_s = time.perf_counter() - t0
    launches = mp.hop_launches - launches0
    color = PF.colors_in_use(topo)[0]
    dead = PF.dead_channels_for_color(st.at, color)
    t0 = time.perf_counter()
    rr = PR.repair_fault(st, dead, verify="full")
    repair_s = time.perf_counter() - t0
    mask = np.zeros(st.at.channels.n, bool)
    mask[dead] = True
    on_dead = int(mask[rr.state.table.chan].sum())
    emit(phase="repair", fabric=f"PDTT {dims}", n=topo.n,
         build_s=build_s, hop_launches=launches, l_max_cold=st.l_max,
         color=color, dead_links=len(dead), repair_s=repair_s,
         flows_rerouted=rr.flows_rerouted, l_max=rr.l_max,
         unreachable=rr.unreachable, deadlock_free=rr.deadlock_free,
         fallback=rr.fallback, readmitted=rr.readmitted,
         served_hops_on_dead=on_dead,
         stage_s={k: v for k, v in rr.stats.items() if k.endswith("_s")})
    check(rr.unreachable == 0 and rr.deadlock_free and not rr.fallback
          and on_dead == 0, f"repair at {dims}: unreachable "
          f"{rr.unreachable}, deadlock_free {rr.deadlock_free}, fallback "
          f"{rr.fallback}, {on_dead} hops on dead channels")
    check(launches > 0, "the serving build never launched the hop kernel")
    return launches


def phase_chaos(PR, PX, PT, mp, dims=(8, 8, 8), replay_dims=(4, 4, 4),
                dev="cuda"):
    """The reference's acceptance campaign on PDTT ``dims`` (its
    arrivals cut to CHAOS_ARRIVALS) with netsim
    probes on the card: every invariant green, a coalesced storm, a
    degraded disconnection, a restore and a full heal within 1.10x of the
    cold build's l_max; then, at ``replay_dims``, two campaigns from one
    seed with probes on the card give one fingerprint."""
    topo = PT.pdtt(dims)
    launches0 = mp.hop_launches
    t0 = time.perf_counter()
    st = PR.ServingState.build(topo, n_vc=2, K=4, seed=0, robust=True,
                               device=dev)
    build_s = time.perf_counter() - t0
    launches = mp.hop_launches - launches0
    sched = PX.generate_schedule(st.at, n_arrivals=CHAOS_ARRIVALS, seed=7)
    t0 = time.perf_counter()
    res = PX.run_campaign(st, sched, coalesce=1.0, probe_every=5,
                          device=dev)
    campaign_s = time.perf_counter() - t0
    recs = res.records
    storms = [r.coalesced for r in recs if r.kind == "storm"]
    emit(phase="chaos_8", fabric=f"PDTT {dims}", n=topo.n, build_s=build_s,
         hop_launches=launches, events=sched.n_events, kinds=sched.kinds(),
         groups=len(recs), largest_storm=max(storms, default=0),
         min_served_fraction=res.min_served_fraction,
         post_heal_l_max=res.state.l_max, cold_l_max=res.baseline_l_max,
         post_heal_vs_cold=res.state.l_max / res.baseline_l_max,
         campaign_s=campaign_s,
         mttr_s=[r.mttr_s for r in recs],
         baseline_probe=res.baseline_probe,
         probes=[dict(event=i, kind=r.kind, **r.probe)
                 for i, r in enumerate(recs) if r.probe is not None],
         all_invariants=res.ok, fingerprint=res.fingerprint())
    check(res.ok, "chaos: an invariant failed: "
          f"{[r.invariants for r in recs if not r.ok]}")
    check(storms and max(storms) > 1, "chaos: no coalesced storm")
    check(any(r.lost_pairs > 0 and not r.fallback for r in recs),
          "chaos: no degraded disconnection")
    check(any(r.kind == "restore" for r in recs), "chaos: no restore")
    check(not any(r.fallback for r in recs), "chaos: a repair fell back")
    check(len(res.state.lost) == 0
          and res.state.table.n_routed() == topo.n * (topo.n - 1)
          and res.records[-1].served_fraction == 1.0,
          "chaos: the final heal left pairs unserved")
    check(res.state.l_max <= 1.10 * res.baseline_l_max,
          f"chaos: post-heal l_max {res.state.l_max} over 1.10x the cold "
          f"build's {res.baseline_l_max}")
    check(all(p["stalled_at"] == -1 and p["delivered"] > 0
              for p in [res.baseline_probe] + [r.probe for r in recs
                                               if r.probe is not None]),
          "chaos: a probe stalled or delivered nothing")

    t0 = time.perf_counter()
    small = PR.ServingState.build(PT.pdtt(replay_dims), n_vc=2, K=4, seed=0,
                                  robust=True, device=dev)
    runs = [PX.run_campaign(small, PX.generate_schedule(
        small.at, n_arrivals=CHAOS_REPLAY_ARRIVALS, seed=7), coalesce=1.0,
        probe_every=5, device=dev) for _ in range(2)]
    same = runs[0].fingerprint() == runs[1].fingerprint() and \
        [r.probe for r in runs[0].records] == \
        [r.probe for r in runs[1].records]
    emit(phase="chaos_replay", fabric=f"PDTT {replay_dims}",
         events=len(runs[0].records), replay_s=time.perf_counter() - t0,
         probes=sum(r.probe is not None for r in runs[0].records),
         same_fingerprint=same,
         all_invariants=runs[0].ok and runs[1].ok,
         fingerprint_crc=list(runs[0].fingerprint()[1:]))
    check(same, "chaos: two campaigns from one seed differ")
    check(runs[0].ok and runs[1].ok, "chaos replay: an invariant failed")
    return launches


# ---------------------------------------------------------------------------
# Synthesis and workload co-design: the LP stack on the csr_spmv kernel
# ---------------------------------------------------------------------------

# cuSPARSE sums a row in another order: a reordered sum of k terms moves
# by at most (k - 1) * eps * (the sum of their magnitudes); k <= 16,576 at
# 8^3 gives 1.9e-12 with eps = 2^-53, so 1e-11 of the row's magnitude
SPMV_LIB_RTOL = 1e-11
# NVIDIA's H100 SXM data sheet: FP64 outside the tensor cores
FP64_FLOPS = 34e12
SYNTH_DIMS = (4, 8, 8)
SPMV_DIMS = (SYNTH_DIMS, (8, 8, 8))
PDHG_DIMS, PDHG_ITERS = (4, 4, 4), 12000
# PR 16's solve_pdhg at PDHG_DIMS, PDHG_ITERS (its CUDA run equalled its
# CPU run; these from its CPU run): no row of the 4^3 LP exceeds
# csr_spmv.SEGMENT, so the segmented order must leave lambda and the
# iterates' bits (sha256 of x and y) as they were. rel_gap is reckoned on
# the host by numpy and BLAS reductions, whose order follows the host's
# CPU: the same x and y give 0.6026496183832573 on the card's host, so it
# is held to PR16_REL_GAP_RTOL
PR16_PDHG = dict(
    lp_lambda=0.002114281365376032, rel_gap=0.6026496183832595,
    x="a90646d0142c15f793ab400a2c306b4edcc299f2efb3ea809ff63435c512980e",
    y="14455d0652540a66bcfae86d4abad55c0af0777bd71e058be1a62c4fd4e2919d")
PR16_REL_GAP_RTOL = 1e-12
# PR 16's lambda per round of synthesize((4, 8, 8), prefer="pdhg") on the
# card (PERF.md section 5)
PR16_LAMBDAS = (0.0024193284642204, 0.0020397131974831, 0.0022107287458099)
# the stored workload fabrics evaluated: deepseek-moe-16b's, cut from it and
# gemma-7b's (~40 s each on the card) for the time limit
WL_ARCHS = ("deepseek-moe-16b",)
# benchmarks/bench_workload.py's evaluation (step 0.02), its replay cut
# from 2000 cycles and a warm-up of 600 for the time limit (the phase:
# 46.1 s at 2000 on a slow host)
WL_SAT = dict(step=0.02, cycles=1000, warmup=300)
WL_RATES, WL_CYCLES = [0.1, 0.4], 1200


def spmv_bound_ms(rows: int, cols: int, nnz: int) -> tuple:
    """Least time for one CSR product: the row offsets (int64), column
    indices (int32), values and vector (f64) read once and the output
    written once at the memory rate, or 2 * nnz f64 operations at the
    FP64 rate; the larger, and which one it is."""
    t_bytes = (8.0 * (rows + 1) + 12.0 * nnz + 8.0 * cols + 8.0 * rows) \
        / PEAK_BYTES * 1e3
    t_ops = 2.0 * nnz / FP64_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_spmv_probe(KS, sm_clock_hz):
    """The latency of a dependent f64 add in SM cycles (``csr_spmv.probe``),
    which sets the order bound of a row's chain of adds. Returns the
    median cycles and the seconds one such add takes at the SM clock."""
    lat = KS.probe()
    emit(phase="spmv_probe", dadd_latency_cycles=lat,
         sm_clock_mhz=sm_clock_hz / 1e6,
         dadd_ns=lat["median"] / sm_clock_hz * 1e9)
    check(lat["threads"] > 0 and 1 <= lat["median"] <= 64,
          f"implausible DADD latency: {lat}")
    return lat["median"], lat["median"] / sm_clock_hz


def segments_coo(rng, seg, n=5000):
    """Rows of 0 to 70,000 entries, around every class boundary of the
    kernel's plan and the order's segments of ``seg``, interleaved at
    random, values over many binades."""
    lens = (0, 1, 31, 32, 33, 256, 257, 1000, seg - 1, seg, seg + 1,
            2 * seg, 2 * seg + 1, 70000)
    rows = rng.permutation(np.repeat(np.arange(len(lens)), lens))
    nnz = len(rows)
    return (rows, rng.integers(0, n, nnz),
            rng.normal(size=nnz) * np.exp(rng.normal(size=nnz) * 4),
            len(lens), n)


def phase_spmv_parity(KS, ref, PL, PS, PT, dadd_s, dims=SPMV_DIMS,
                      dev="cuda"):
    """The csr_spmv kernel on A and A^T of the Ruiz-scaled synthesis LP at
    each of ``dims`` (the PDHG loop's two products), on a ragged CSR with
    duplicates and empty rows and on rows of 0 to 70,000 entries
    (``segments``): equal (``torch.equal``) to the plain version on the
    CPU, within SPMV_LIB_RTOL of torch.sparse's CSR mv (cuSPARSE, on the
    same matrix with duplicates summed); then timed at the LP shapes
    beside two bounds: bytes, and the order's longest chain of adds at
    ``dadd_s`` seconds each. Returns the timings by shape and the
    largest difference from the plain version."""
    import scipy.sparse as sp
    rng = np.random.default_rng(0)
    cases = {}
    for d in dims:
        lp = PS.build_synthesis_lp(PT.Pod(d))
        vals_s, _, _ = PL._ruiz_scale(lp.A)
        rows, cols = lp.A.rows.astype(np.int64), lp.A.cols.astype(np.int64)
        m, n = lp.A.shape
        tag = "x".join(map(str, d))
        cases[f"A x {tag}"] = (rows, cols, vals_s, m, n)
        cases[f"AT y {tag}"] = (cols, rows, vals_s, n, m)
    r_rows = rng.integers(0, 4000, 60000)        # rows 4000.. stay empty
    r_rows[:5000] = r_rows[5000:10000]
    r_cols = rng.integers(0, 3000, 60000)
    r_cols[:5000] = r_cols[5000:10000]           # duplicate entries
    cases["ragged"] = (r_rows, r_cols, rng.normal(size=60000) *
                       np.exp(rng.normal(size=60000) * 4), 4500, 3000)
    cases["segments"] = segments_coo(rng, KS.SEGMENT)
    out, worst = {}, 0.0
    for name, (r, c, v, nr, nc) in cases.items():
        x = torch.from_numpy(rng.normal(size=nc) *
                             np.exp(rng.normal(size=nc) * 4)
                             if name == "segments" else rng.normal(size=nc))
        cpu = PL.CSR.from_coo(r, c, v, nr, "cpu")
        want = cpu @ x
        a = PL.CSR.from_coo(r, c, v, nr, dev)
        xd = x.to(dev)
        got = KS.csr_spmv(a.indptr, a.indices, a.vals, xd, a.plan)
        torch.cuda.synchronize()
        err = float((got.cpu() - want).abs().max())
        worst = max(worst, err)
        # torch.sparse takes sorted, distinct columns in each row: the
        # same matrix with its duplicates summed (scipy)
        sc = sp.coo_matrix((v, (r, c)), shape=(nr, nc)).tocsr()
        sc.sort_indices()
        lib = torch.sparse_csr_tensor(
            torch.as_tensor(sc.indptr.astype(np.int64), device=dev),
            torch.as_tensor(sc.indices.astype(np.int64), device=dev),
            torch.as_tensor(sc.data, device=dev), (nr, nc),
            check_invariants=True)
        lib_out = (lib @ xd).cpu()
        mag = ref.csr_spmv_ref(cpu.indptr, cpu.indices, cpu.vals.abs(),
                               x.abs())
        lib_ok = bool(((lib_out - want).abs() <= SPMV_LIB_RTOL * mag).all())
        lens = cpu.indptr.diff()
        longest = int(lens.max())
        line = dict(phase="spmv_parity", operand=name, rows=nr, cols=nc,
                    nnz=len(v), longest_row=longest,
                    median_row=float(lens.double().median()),
                    empty_rows=int((lens == 0).sum()),
                    plan=dict(long=a.plan.n_long, warp=a.plan.n_warp,
                              quarter=a.plan.n_quarter, short=a.plan.n_short),
                    equal_to_cpu_plain=torch.equal(got.cpu(), want),
                    max_abs_err=err, library_within_rtol=lib_ok,
                    library_max_abs_diff=float((lib_out - want).abs().max()),
                    library_rtol=SPMV_LIB_RTOL)
        if name not in ("ragged", "segments"):
            bound, by = spmv_bound_ms(nr, nc, len(v))
            chain = KS.order_chain(longest)
            row = dict(
                ms=cuda_ms(lambda: KS.csr_spmv(a.indptr, a.indices, a.vals,
                                               xd, a.plan), 200),
                **device_ms(lambda: KS.run(a.indptr, a.indices, a.vals,
                                           xd, a.plan), 50, "csr_spmv"),
                plain_ms=cuda_ms(lambda: ref.csr_spmv_ref(
                    a.indptr, a.indices, a.vals, xd), 50),
                library_ms=cuda_ms(lambda: lib @ xd, 200),
                bound_ms=bound, bound_by=by, order_chain_adds=chain,
                order_bound_ms=chain * dadd_s * 1e3)
            row["bound_share"] = bound_share(
                max(bound, row["order_bound_ms"]), row)
            out[name] = row
            line.update(row)
        emit(**line)
        check(line["equal_to_cpu_plain"],
              f"csr_spmv {name} differs from the plain version: {err}")
        check(lib_ok, f"csr_spmv {name} is not within {SPMV_LIB_RTOL} of "
              "torch.sparse")
    return out, worst


def phase_pdhg_determinism(KS, PL, PS, PT, dims=PDHG_DIMS,
                           iters=PDHG_ITERS, dev="cuda"):
    """solve_pdhg on the synthesis LP at ``dims`` on the card (the chunk
    as a CUDA graph) and on the CPU (one thread, eager): x, y, obj, iters
    and status equal; lambda, x and y equal to PR 16's bits, rel_gap
    within PR16_REL_GAP_RTOL of PR 16's."""
    lp = PS.build_synthesis_lp(PT.Pod(dims))
    kw = dict(max_iters=iters, tol=2e-4)
    launches0, replays0 = KS.launches, PL.graph_replays
    t0 = time.perf_counter()
    got = PL.solve_pdhg(lp.c, lp.A, lp.b, lp.lo, lp.hi, device=dev, **kw)
    cuda_s = time.perf_counter() - t0
    launches = KS.launches - launches0
    replays = PL.graph_replays - replays0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    want = PL.solve_pdhg(lp.c, lp.A, lp.b, lp.lo, lp.hi, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    same = {k: bool(np.array_equal(getattr(got, k), getattr(want, k)))
            for k in ("x", "y", "obj", "iters", "status")}
    pr16 = dict(lp_lambda=-got.obj == PR16_PDHG["lp_lambda"],
                x=sha256(got.x.tobytes()).hexdigest() == PR16_PDHG["x"],
                y=sha256(got.y.tobytes()).hexdigest() == PR16_PDHG["y"],
                rel_gap=abs(got.rel_gap - PR16_PDHG["rel_gap"])
                <= PR16_REL_GAP_RTOL * PR16_PDHG["rel_gap"])
    emit(phase="pdhg_determinism", dims=list(dims), lp_shape=list(lp.A.shape),
         nnz=len(lp.A.vals), iters=got.iters, status=got.status,
         lp_lambda=-got.obj, rel_gap=got.rel_gap,
         primal_infeas=got.primal_infeas, cuda_s=cuda_s, cpu_s=cpu_s,
         iters_per_s=got.iters / cuda_s, csr_spmv_launches=launches,
         graph_replays=replays, equal=same, pr16=PR16_PDHG,
         equal_to_pr16=pr16)
    check(all(same.values()), f"solve_pdhg CUDA and CPU differ: {same}")
    check(all(pr16.values()), f"solve_pdhg at 4^3 moved from PR 16: {pr16}")
    check(launches == 2 * got.iters or dev == "cpu",
          f"{launches} csr_spmv launches for {got.iters} iterations")
    check(replays == got.iters // 250 - 1 or dev == "cpu",
          f"{replays} graph replays for {got.iters} iterations")


def phase_pdhg_chunk(KS, PL, solve, inner=250, dev="cuda"):
    """One PDHG chunk of ``inner`` iterations on a recorded round's LP (the
    first round of the 4x8x8 synthesis, where A^T's column of lambda is
    longer than csr_spmv.SEGMENT) from its cold start: the CUDA graph's
    replay, and the eager first run that precedes its capture, equal the
    functional chunk on the CPU (one thread) bit for bit."""
    (c, A, b, lo, hi), _, _ = solve
    c, b, lo, hi = (np.asarray(v, np.float64) for v in (c, b, lo, hi))
    vals_s, dr, dc, tau, cs, bs, los, his = PL._scale(c, A, b, lo, hi)
    x0 = np.clip(np.zeros(A.shape[1]), los, his)
    y0 = np.zeros(A.shape[0])

    def on(device):
        ops = PL._operators(A, vals_s, device)
        vecs = [torch.as_tensor(np.ascontiguousarray(v), device=device)
                for v in (cs, bs, los, his, x0, y0)]
        return ops, vecs

    (Ad, ATd), (cj, bj, loj, hij, xj, yj) = on(dev)
    chunk = PL._Chunk(Ad, ATd, cj, bj, loj, hij, tau, tau, inner)
    launches0 = KS.launches
    t0 = time.perf_counter()
    eager = [t.cpu() for t in chunk.run(xj, yj)]
    eager_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graphed = [t.cpu() for t in chunk.run(xj, yj)]
    replay_s = time.perf_counter() - t0
    launches = KS.launches - launches0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    (Ac, ATc), (cc, bc, loc, hic, xc, yc) = on("cpu")
    t0 = time.perf_counter()
    want = PL._pdhg_chunk(Ac, ATc, cc, bc, loc, hic, xc, yc, tau, tau, inner)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    names = ("x", "y", "x_avg", "y_avg")
    same = {k: bool(torch.equal(g, w)) for k, g, w in
            zip(names, graphed, want)}
    same_eager = {k: bool(torch.equal(g, w)) for k, g, w in
                  zip(names, eager, want)}
    emit(phase="pdhg_chunk_4x8x8", lp_shape=list(A.shape), nnz=len(A.vals),
         inner=inner, at_longest_row=int(ATd.indptr.diff().max()),
         at_long_rows=ATd.plan.n_long, spmv_nodes=chunk.spmv_launches,
         csr_spmv_launches=launches, eager_and_capture_s=eager_s,
         replay_s=replay_s, replay_iters_per_s=inner / replay_s,
         cpu_s=cpu_s, equal_graphed=same, equal_eager=same_eager)
    check(all(same.values()) and all(same_eager.values()),
          f"PDHG chunk: CUDA graph {same}, eager {same_eager} against CPU")
    check(ATd.plan.n_long > 0, "the chunk's A^T has no row over SEGMENT")
    check(chunk.spmv_launches == 2 * inner and launches == 4 * inner,
          f"PDHG chunk: {chunk.spmv_launches} nodes, {launches} launches")


def phase_synthesis(PS, MC, dims=SYNTH_DIMS, dev="cuda", **synth_kw):
    """``synthesize(dims, prefer="pdhg")`` on the card and the routed
    fabric's end-to-end scalars; returns the result and each PDHG
    round's arguments and LPResult (for the repeat below)."""
    solves = []
    solve_pdhg = PS.solve_pdhg

    def recorded(c, A, b, lo, hi, **kw):
        res = solve_pdhg(c, A, b, lo, hi, **kw)
        solves.append(((c, A, b, lo.copy(), hi.copy()), kw, res))
        return res

    PS.solve_pdhg = recorded
    try:
        t0 = time.perf_counter()
        res = PS.synthesize(dims, prefer="pdhg", device=dev, **synth_kw)
        synth_s = time.perf_counter() - t0
    finally:
        PS.solve_pdhg = solve_pdhg
    log = res.stats["solves"]
    iters = sum(s["iters"] for s in log)
    pdhg_s = sum(s["s"] for s in log)
    t0 = time.perf_counter()
    ee = PS.evaluate_end_to_end(res.topology, device=dev)
    e2e_s = time.perf_counter() - t0
    n = res.topology.n
    # the order of A^T's column of lambda changed on purpose: a different
    # third round or fabric is a finding, not a failure
    emit(phase="synthesis_4x8x8", dims=list(dims), n=n, synth_s=synth_s,
         build_s=res.stats["build_s"], n_var=res.stats["n_var"],
         n_rows=res.stats["n_rows"], nnz=res.stats["nnz"],
         interval=res.stats["interval"], rounds=len(res.lambdas),
         pdhg_iters=iters, pdhg_s=pdhg_s,
         iters_per_s=iters / max(pdhg_s, 1e-9),
         lambdas=res.lambdas, lambdas_pr16=PR16_LAMBDAS,
         lambda_rel_diff_pr16=[abs(a - b) / abs(b) for a, b in
                               zip(res.lambdas, PR16_LAMBDAS)],
         rel_gap=[r.rel_gap for _, _, r in solves],
         primal_infeas=[r.primal_infeas for _, _, r in solves],
         statuses=[s["status"] for s in log],
         basu_bound=MC.mcf_upper_bound_basu(n), n_orbits=res.n_orbits,
         n_fixed=res.n_fixed, n_completed=res.n_completed,
         status=res.status, l_max=ee["l_max"], avg_hops=ee["avg_hops"],
         end_to_end=ee, end_to_end_s=e2e_s)
    check(res.status == "ok" and all(s["solver"] == "pdhg" for s in log),
          f"synthesis: status {res.status}, solvers {log}")
    deg = np.bincount(res.topology.edges().ravel(), minlength=n)
    check((deg == 6).all(), "synthesis: the fabric is not radix-6")
    check(ee["deadlock_free"] and ee["unreachable"] == 0,
          f"synthesis: routed fabric {ee}")
    return res, ee, solves


def phase_synthesis_repeat(PL, solves):
    """The first PDHG round's LP solved again: x and y equal."""
    (c, A, b, lo, hi), kw, first = solves[0]
    t0 = time.perf_counter()
    again = PL.solve_pdhg(c, A, b, lo, hi, **kw)
    same = bool(np.array_equal(again.x, first.x)
                and np.array_equal(again.y, first.y)
                and again.iters == first.iters)
    emit(phase="synthesis_4x8x8_repeat", iters=again.iters,
         seconds=time.perf_counter() - t0, equal_x_y=same)
    check(same, "synthesis: the first round's LP solved twice differs")


def load_workload_fabric(convert, arch):
    return convert.load_fabric(
        ROOT / "benchmarks" / "results" / f"tons_wl_128_{arch}.pkl",
        (4, 4, 8), name=f"TONS_WL 128 {arch}")


def phase_workload(PW, convert, PipelineConfig, dev="cuda", sat=WL_SAT):
    """``evaluate_workload`` of the stored workload fabrics of WL_ARCHS,
    each on its arch's analytic demand (train_4k), routed and swept as
    bench_workload.py does; the reference's stored CPU values beside
    them as context only (ROADMAP caveat R2)."""
    stored = json.loads((ROOT / "BENCH_workload.json").read_text())
    stored = stored["sizes"]["n128"]["workloads"]
    cfg = PipelineConfig(K=4, engine="array", local_search_rounds=1)
    for arch in WL_ARCHS:
        topo = load_workload_fabric(convert, arch)
        wd = PW.workload_demand((4, 4, 8), arch)
        t0 = time.perf_counter()
        ev = PW.evaluate_workload(topo, wd, trace=PW.replay_trace(wd),
                                  cfg=cfg, sat_kwargs=sat, device=dev)
        secs = time.perf_counter() - t0
        emit(phase="workload_128", arch=arch, fabric=topo.name,
             demand=dict(w_same_cube=wd.w_same_cube, w_ring=wd.w_ring,
                         w_uniform=wd.w_uniform), seconds=secs, **sat,
             **{k: ev[k] for k in ("weighted_mcf", "l_max",
                                   "trace_saturation")},
             reference_cpu_stored=stored.get(arch, {}).get("specialized"))
        check(ev["weighted_mcf"] > 0 and 0 < ev["trace_saturation"] <= 1,
              f"workload {arch}: {ev}")


def phase_workload_determinism(PW, PNS, convert, PipelineConfig, route_pod,
                               dev="cuda"):
    """The trace replay of the MoE fabric (its demand-weighted routing)
    at 2 rates and WL_CYCLES cycles: the CUDA sweep equals the CPU's."""
    arch = WL_ARCHS[0]
    topo = load_workload_fabric(convert, arch)
    wd = PW.workload_demand((4, 4, 8), arch)
    rp = route_pod(topo, PipelineConfig(K=4, engine="array",
                                        local_search_rounds=1),
                   pair_weight=PW.demand_pair_weight(wd), device=dev)
    trace = PW.replay_trace(wd)
    kw = dict(traffic=trace, cycles=WL_CYCLES, warmup=WL_CYCLES // 3)
    t0 = time.perf_counter()
    got = PNS.sweep(rp.tables, WL_RATES, device=dev, **kw)
    cuda_s = time.perf_counter() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    want = PNS.sweep(rp.tables, WL_RATES, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    emit(phase="workload_128_determinism", arch=arch, rates=WL_RATES,
         cycles=WL_CYCLES, phases=list(trace.cycles), equal=got == want,
         delivered=[r["delivered"] for r in got], cuda_s=cuda_s,
         cpu_s=cpu_s)
    check(got == want, "workload replay: CUDA and CPU sweeps differ")
    check(_conserving(got), "workload replay: conservation fails")


def phase_parallel(fa, PM, L, get_config, train_losses, bf16_flops_per_s,
                   moe_ffn_figures=None, dev="cuda"):
    """The data-parallel path at world size 1 under NCCL (a ``file://``
    rendezvous in a temporary directory) and ``make_host_mesh()``:
    (a) qwen2.5-3b at full width trained PARALLEL_STEPS steps with
    train_full's settings (seed 0, B 4, S 128, lr 3e-4, total 8, warmup
    5; checkpoints off): the losses must equal train_full's first ones
    bit for bit, and the int8 compressed all-reduce of one step's
    gradients must equal ``compress_grads`` bit for bit; (b)
    deepseek-moe-16b at TRAIN_FAMILY_LAYERS' cut with
    ``opt_moe_local_dispatch`` under a ("data", "model") (2, 1) mesh held
    by this process (``moe_ffn_local`` over 2 shards), PARALLEL_STEPS
    steps at B 4, S 128, then one profiled: finite losses and norms, its
    figures printed beside ``moe_ffn_figures`` (the same cut through
    ``moe_ffn`` in this run's train_family_full, if it ran); (c) one deepseek MoE layer at published width (seed 0, 4 x 128
    tokens) through ``moe_ffn_local`` at dp 2 on the CPU and twice on
    CUDA, forward and backward: the two CUDA runs equal bit for bit; CUDA
    against the CPU, the first shard routed otherwise does so at near
    ties only, and following the CPU's experts y is within
    MOE_LAYER_ROW_REL. The flash kernel must not launch. Returns its
    launches."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import api
    from repro_torch.train.loop import all_reduce_int8, compress_grads
    t = [time.perf_counter()]
    fa.launches = 0                                  # the parallel path
    init_dir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{init_dir}/init",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        check(mesh.shape == (1, 1) and api.processes() == 1
              and mesh.device_mesh is not None,
              f"make_host_mesh() under one NCCL rank: {mesh}")
        # (a) qwen2.5-3b at full width, world size 1
        cfg = get_config(TRAIN_ARCH).model
        gc.collect()
        torch.cuda.empty_cache()
        with api.mesh_context(mesh), tempfile.TemporaryDirectory(
                prefix="chip_smoke_parallel_") as d:
            tr = train_config(cfg, PARALLEL_STEPS, d, TRAIN_LR,
                              max(TRAIN_STEPS // 10, 5), TRAIN_STEPS,
                              TRAIN_BATCH, TRAIN_SEQ, dev)
            tr.ckpt.save = lambda *a, **kw: None
            out = tr.run()
            from repro_torch.models import model as M
            params = dict(tr.model.named_parameters())
            loss = M.loss_fn(cfg, tr.model,
                             tr.data.torch_batch(PARALLEL_STEPS, dev))
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            int8_equal = all(torch.equal(
                all_reduce_int8({n: g}, 1)[n], compress_grads({n: g})[n])
                for n, g in grads.items())
        losses = out["losses"]
        del tr, params, grads, loss
        t.append(time.perf_counter())
        want = train_losses[:PARALLEL_STEPS]
        emit(phase="parallel_world1", arch=cfg.name, backend="nccl",
             world_size=dist.get_world_size(), mesh=list(mesh.shape),
             steps=PARALLEL_STEPS, losses=losses, train_full_losses=want,
             losses_equal=losses == want, step_times_s=out["step_times"],
             int8_all_reduce_equals_compress_grads=int8_equal,
             seconds=t[-1] - t[-2])
        check(losses == want, f"world-1 losses {losses} are not train_full's "
              f"{want}")
        check(int8_equal, "the int8 all-reduce at world 1 differs from "
              "compress_grads")

        # (b) deepseek-moe-16b cut, per-shard dispatch over 2 shards
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        arch = "deepseek-moe-16b"
        fcfg = dataclasses.replace(
            family_config(get_config, arch, TRAIN_FAMILY_LAYERS),
            opt_moe_local_dispatch=True)
        shards = api.Mesh(("data", "model"), (PARALLEL_SHARDS, 1))
        with api.mesh_context(shards), tempfile.TemporaryDirectory(
                prefix="chip_smoke_parallel_") as d:
            tr = train_config(fcfg, PARALLEL_STEPS, d, TRAIN_LR,
                              max(TRAIN_STEPS // 10, 5), TRAIN_STEPS,
                              TRAIN_BATCH, TRAIN_SEQ, dev)
            tr.ckpt.save = lambda *a, **kw: None
            norms, step_fn = [], tr.step_fn

            def recorded(*a):
                stats = step_fn(*a)
                norms.append(float(stats["grad_norm"]))
                return stats
            tr.step_fn = recorded
            shard_calls = []
            route = L.moe_route
            L.moe_route = lambda p, xf, c, C: shard_calls.append(
                xf.shape[0]) or route(p, xf, c, C)
            try:
                out = tr.run()
            finally:
                L.moe_route = route
            batch = tr.data.torch_batch(PARALLEL_STEPS, dev)
            prof = busy_share(lambda: step_fn(tr.model, tr.opt_state, batch))
        n_params = sum(p.numel() for p in tr.model.parameters())
        del tr
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fl = out["losses"]
        step_s = statistics.median(out["step_times"][1:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        fpt = train_flops_per_token(fcfg, n_params, TRAIN_SEQ)
        t.append(time.perf_counter())
        emit(phase="parallel_moe_local", arch=arch, n_layers=fcfg.n_layers,
             d_model=fcfg.d_model, n_params=n_params,
             mesh=list(shards.shape), shards_held=PARALLEL_SHARDS,
             tokens_per_route_call=sorted(set(shard_calls)),
             route_calls=len(shard_calls), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
             steps=len(fl), losses=fl, grad_norms=norms,
             step_times_s=out["step_times"], median_step_s_after_first=step_s,
             tokens_per_s=tokens / step_s,
             model_tflops_per_s=fpt * tokens / step_s / 1e12,
             bf16_peak_share=fpt * tokens / step_s / bf16_flops_per_s,
             kernels_per_step=prof["kernels"], busy_share=prof["busy_share"],
             profiled_step_s=prof["wall_s"],
             device_busy_s=prof["device_busy_s"], max_memory_gb=peak_gb,
             moe_ffn_same_cut=moe_ffn_figures, seconds=t[-1] - t[-2])
        check(all(math.isfinite(x) for x in fl + norms),
              f"{arch} per-shard: non-finite losses or norms {fl} {norms}")
        check(set(shard_calls) == {tokens // PARALLEL_SHARDS},
              f"{arch}: route calls of {sorted(set(shard_calls))} tokens, "
              f"not one a shard of {tokens // PARALLEL_SHARDS}")
        gc.collect()
        torch.cuda.empty_cache()

        # (c) one MoE layer at published width, CPU against CUDA
        moe_cpu = L.init_weights_(L.MoE(fcfg, "cpu"), 0)
        moe_gpu = copy.deepcopy(moe_cpu).to(dev).requires_grad_(True)
        g = torch.Generator().manual_seed(0)
        x = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, fcfg.d_model, generator=g)
             + torch.randn(fcfg.d_model, generator=g)).bfloat16()
        ct = torch.randn(x.shape, generator=g).bfloat16()
        logs = {"cpu": [], "cuda": [], "cuda2": [], "follow": []}

        def layer(m, d, log, follow=None, grad=False):
            orig = _route_log(L, log, follow)
            try:
                with api.mesh_context(shards):
                    xd = x.to(d).requires_grad_(grad)
                    y, aux = L.moe_ffn_local(m, xd, fcfg)
                    if not grad:
                        return y.detach(), aux.detach()
                    gs = torch.autograd.grad(
                        (y, aux), [xd] + list(m.parameters()),
                        (ct.to(d), torch.ones((), device=d)))
                    return y.detach(), aux.detach(), gs
            finally:
                L.moe_route = orig
        with torch.no_grad():
            y_cpu, aux_cpu = layer(moe_cpu, "cpu", logs["cpu"])
        runs = [layer(moe_gpu, dev, logs[k], grad=True)
                for k in ("cuda", "cuda2")]
        repeat = torch.equal(runs[0][0], runs[1][0]) and \
            torch.equal(runs[0][1], runs[1][1]) and \
            all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
        first = None
        for i, ((a, probs), (b, _)) in enumerate(zip(logs["cpu"],
                                                     logs["cuda"])):
            if not torch.equal(a, b):
                top = probs.sort(dim=1, descending=True).values
                gap = top[:, fcfg.top_k - 1] - top[:, fcfg.top_k]
                toks = torch.nonzero((a != b).any(1)).flatten()
                first = {"shard": i, "tokens": len(toks),
                         "max_prob_gap": float(gap[toks].max()),
                         "near_tie": bool((gap[toks] < NEAR_TIE).all())}
                break
        with torch.no_grad():
            y_f, aux_f = layer(moe_gpu, dev, logs["follow"], logs["cpu"])
        err = row_rel_err(y_f.cpu(), y_cpu)
        t.append(time.perf_counter())
        emit(phase="parallel_moe_layer", arch=arch, d_model=fcfg.d_model,
             experts=fcfg.n_experts, top_k=fcfg.top_k,
             tokens=TRAIN_BATCH * TRAIN_SEQ, shards=PARALLEL_SHARDS,
             route_calls=len(logs["cpu"]), cuda_runs_equal=repeat,
             first_routing_difference=first,
             following_cpu_row_rel_err=err, row_rel_bound=MOE_LAYER_ROW_REL,
             aux_cpu=float(aux_cpu), aux_cuda=float(runs[0][1]),
             aux_following=float(aux_f), seconds=t[-1] - t[-2])
        check(repeat, "two CUDA runs of moe_ffn_local differ")
        check(len(logs["cpu"]) == len(logs["cuda"]) == PARALLEL_SHARDS,
              f"route calls {len(logs['cpu'])} / {len(logs['cuda'])}")
        check(first is None or first["near_tie"],
              f"CPU and CUDA route otherwise without a near tie: {first}")
        check(err <= MOE_LAYER_ROW_REL, f"moe_ffn_local following the CPU's "
              f"experts is {err} from the CPU")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(init_dir, ignore_errors=True)
    launches = fa.launches
    emit(phase="parallel_seconds", phase_s=dict(zip(
        ("world1_qwen", "moe_local_deepseek", "moe_layer"),
        np.diff(t).tolist())), seconds=t[-1] - t[0], flash_launches=launches)
    check(launches == 0, f"the parallel path launched the flash kernel "
          f"{launches} times")
    return launches


def dryrun_process(outdir, *args, dev="cuda"):
    """``python -m repro_torch.launch.dryrun`` with ``args`` writing into
    ``outdir``, started in a process of its own (its fake group cannot
    share this process with NCCL)."""
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--device", dev, "--outdir", str(outdir), "--force"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def spmd_world1(cfg, dev="cuda"):
    """``cfg`` from seed 0 through ``spmd.build`` and ``spmd.make_step`` on
    a (1, 1) mesh of the one NCCL rank that is up, at train_full's
    settings (B 4, S 128, lr 3e-4, warmup 5, total 8; an
    encoder-decoder's frames from ``extra_inputs``, as the launcher
    draws them) for PARALLEL_STEPS steps: (losses, the collectives its
    recorder logged each step, the step times, the card's peak over the
    first step above what was allocated before, the bytes of the rank's
    state)."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import extra_inputs
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import OptConfig, init
    from repro_torch.parallel import spmd
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    mesh = make_mesh(("data", "model"), (1, 1))
    whole = M.init_params(cfg, 0, dev)
    state = spmd.shard_state(whole, mesh, 0)
    del whole
    model = spmd.build(cfg, mesh, dev, state)
    del state
    opt_state = init(model.local_params())
    step = spmd.make_step(OptConfig(
        lr=TRAIN_LR, total_steps=TRAIN_STEPS,
        warmup_steps=max(TRAIN_STEPS // 10, 5)))
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH))
    extra = extra_inputs(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    gc.collect()
    torch.cuda.empty_cache()
    losses, logs, times = [], [], []
    for s in range(PARALLEL_STEPS):
        batch = spmd.rank_rows(data.torch_batch(
            s, dev, extra(s) if extra else None), model.place)
        torch.cuda.synchronize()
        if s == 0:
            torch.cuda.reset_peak_memory_stats()
        rec = spmd.Recorder()
        t1 = time.perf_counter()
        with rec:
            losses.append(float(step(model, opt_state, batch)["loss"]))
        times.append(time.perf_counter() - t1)
        logs.append([list(r) for r in rec.log])
        if s == 0:
            peak = torch.cuda.max_memory_allocated() - base
    state_bytes = sum(t.numel() * t.element_size() for t in
                      list(model.local_params().values())
                      + list(opt_state["m"].values())
                      + list(opt_state["v"].values()))
    del model, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return losses, logs, times, peak, state_bytes


def phase_dryrun(fa, get_config, train_losses, family_losses, dev="cuda"):
    """The training dry run and the sharded step (``parallel.spmd``). Four
    dry-run processes start together: (a) DRYRUN_ARCHS' production
    cells, train_4k on ``single_pod_16x16`` under a fake group of 256
    ranks, each through the CLI, and the fake run of (b)'s first step at
    (1, 1). (b) Meanwhile, on a (1, 1) mesh of one NCCL rank
    (:func:`spmd_world1`): qwen2.5-3b at full width, whose losses must
    equal train_full's first ones bit for bit, whose recorder's log of
    the first step must equal the fake run's (both empty: a world of one
    rank runs no collective), and whose fake ``peak_live_bytes`` must
    be within DRYRUN_PEAK_REL of the card's peak over the first step;
    then each arch of DRYRUN_WORLD1_ARCHS at TRAIN_FAMILY_LAYERS' cut
    (deepseek-moe-16b's MoE runs ``layers.moe_ffn_ep`` with all experts
    and no group; mamba2-2.7b's Mamba mixers and seamless-m4t-medium's
    encoder and decoder run unsplit), whose losses must equal
    ``family_losses[arch]`` bit for bit (this run's train_family_full of
    the same model at the same settings) and whose log must be empty.
    The flash kernel must not launch. Returns its launches."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    fa.launches = 0                                    # the dry-run path
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    procs = {arch: dryrun_process(out, "--arch", arch, "--shape", "train_4k",
                                  "--mesh", "single", dev=dev)
             for arch in DRYRUN_ARCHS}
    procs["world1"] = dryrun_process(
        out / "world1", "--arch", TRAIN_ARCH, "--mesh-shape", "1,1",
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log",
        dev=dev)
    init_dir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{init_dir}/init",
                            rank=0, world_size=1)
    families = {}
    try:
        losses, logs, times, peak, state_bytes = spmd_world1(
            get_config(TRAIN_ARCH).model, dev)
        for arch in DRYRUN_WORLD1_ARCHS:
            t_arch = time.perf_counter()
            fcfg = family_config(get_config, arch, TRAIN_FAMILY_LAYERS)
            f_losses, f_logs, f_times, f_peak, _ = spmd_world1(fcfg, dev)
            families[arch] = dict(
                cfg=fcfg, losses=f_losses, logs=f_logs, times=f_times,
                peak=f_peak, seconds=time.perf_counter() - t_arch)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(init_dir, ignore_errors=True)
    t1 = time.perf_counter()
    logs_out = {}
    try:
        for name, p in procs.items():
            logs_out[name] = p.communicate(timeout=max(
                DRYRUN_TIMEOUT_S - (time.perf_counter() - t0), 1))[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wait_s = time.perf_counter() - t1
    failed = {n: logs_out.get(n, "")[-3000:] for n, p in procs.items()
              if p.returncode != 0}
    check(not failed, f"dry-run processes failed: {failed}")
    cells = {}
    for arch in DRYRUN_ARCHS:
        rec = json.loads((out / f"{arch}__train_4k__single_pod_16x16.json")
                         .read_text())
        cells[arch] = rec
        emit(phase="dryrun_cell", arch=arch, shape="train_4k",
             mesh=rec["mesh"], chips=rec["chips"],
             collectives={k: {"count": v["count"],
                              "wire_bytes": v["wire_bytes"],
                              "operand_bytes": v["operand_bytes"]}
                          for k, v in rec["collectives"].items()},
             wire_bytes_per_dev=rec["wire_bytes_per_dev"],
             flops_per_dev=rec["flops_per_dev"],
             bytes_per_dev=rec["bytes_per_dev"], memory=rec["memory"],
             fits_h100_80g=rec["memory"]["fits_h100_80g"],
             terms=rec["terms"], rates=rec["rates"],
             useful_flop_ratio=rec["useful_flop_ratio"],
             trace_s=rec["trace_s"], device=rec["device"])
        check(rec["collectives"] and rec["flops_per_dev"] > 0
              and rec["memory"]["peak_live_bytes"]
              > rec["memory"]["argument_bytes"],
              f"{arch}: an empty dry-run record")
    (fake,) = [json.loads(f.read_text())
               for f in (out / "world1").glob("*.json")]
    shutil.rmtree(out, ignore_errors=True)
    fake_peak = fake["memory"]["peak_live_bytes"]
    want = train_losses[:PARALLEL_STEPS]
    launches = fa.launches
    emit(phase="dryrun_world1", arch=TRAIN_ARCH, backend="nccl", mesh=[1, 1],
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=PARALLEL_STEPS,
         losses=losses, train_full_losses=want, losses_equal=losses == want,
         step_times_s=times, collectives_real=logs[0],
         collectives_fake=fake["collective_log"],
         collectives_equal=logs[0] == fake["collective_log"],
         peak_bytes=peak, fake_peak_live_bytes=fake_peak,
         peak_rel=abs(fake_peak - peak) / peak,
         state_bytes=state_bytes,
         fake_state_bytes=fake["memory"]["alias_bytes"] - 4,
         fake_trace_s=fake["trace_s"],
         flash_launches=launches)
    for arch, f in families.items():
        want_f = list(family_losses.get(arch) or [])[:PARALLEL_STEPS]
        emit(phase="dryrun_world1_family", arch=arch, backend="nccl",
             mesh=[1, 1], family=f["cfg"].family,
             n_layers=f["cfg"].n_layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
             steps=PARALLEL_STEPS, losses=f["losses"],
             train_family_full_losses=want_f,
             losses_equal=f["losses"] == want_f, step_times_s=f["times"],
             collectives=f["logs"][0], peak_bytes=f["peak"],
             seconds=f["seconds"])
    emit(phase="dryrun_seconds", seconds=time.perf_counter() - t0,
         waited_for_processes_s=wait_s)
    check(losses == want, f"the sharded step's losses {losses} are not "
          f"train_full's {want}")
    for arch, f in families.items():
        want_f = list(family_losses.get(arch) or [])[:PARALLEL_STEPS]
        check(len(want_f) == PARALLEL_STEPS and f["losses"] == want_f,
              f"{arch}: the sharded step's losses {f['losses']} are not "
              f"train_family_full's {want_f}")
        check(f["logs"][0] == [], f"{arch}: the real step's collectives "
              f"{f['logs'][0]} at world 1")
    check(logs[0] == fake["collective_log"] == [],
          f"the real step's collectives {logs[0]} are not the fake run's "
          f"{fake['collective_log']}, none at world 1")
    check(abs(fake_peak - peak) <= DRYRUN_PEAK_REL * peak,
          f"fake peak {fake_peak} is not within {DRYRUN_PEAK_REL} of the "
          f"card's {peak}")
    check(state_bytes == fake["memory"]["alias_bytes"] - 4,
          f"the card's state {state_bytes} B is not the fake run's")
    check(launches == 0, f"the dry-run path launched the flash kernel "
          f"{launches} times")
    return launches


def flash_dispatch(fa, ops, dev="cuda"):
    """Host ms a call of the flash kernel through the custom op
    (``ops.flash_attention``) and through its ctypes wrapper called
    directly (``flash_attention.flash_attention``), FLASH_DISPATCH_CALLS
    calls back to back between two synchronisations, in the order op,
    direct, direct, op; the difference is the op's dispatch."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = _attn_inputs(g, 1, 16, 2, FLASH_DISPATCH_S, FLASH_DISPATCH_S,
                           128, torch.bfloat16, model_layout=True)
    calls = {"op": lambda: ops.flash_attention(q, k, v),
             "direct": lambda: fa.flash_attention(q, k, v)}
    check(torch.equal(calls["op"](), calls["direct"]()),
          "the flash op and its wrapper differ")
    for fn in calls.values():
        for _ in range(10):
            fn()
    ms = {"op": [], "direct": []}
    for name in ("op", "direct", "direct", "op"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(FLASH_DISPATCH_CALLS):
            calls[name]()
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t) / FLASH_DISPATCH_CALLS
                        * 1e3)
    out = {n: statistics.mean(v) for n, v in ms.items()}
    return dict(op_ms=out["op"], direct_ms=out["direct"],
                dispatch_ms=out["op"] - out["direct"], runs_ms=ms)


def sharded_serve(fa, cfg, prompts, dev="cuda"):
    """``cfg`` from seed 0 on the card, served twice on one NCCL rank: each
    prompt prefilled alone into a cache DRYRUN_SERVE_STEPS longer (an
    encoder-decoder's with zero frames of its length,
    :func:`prefill_batch`), then DRYRUN_SERVE_STEPS greedy decode steps;
    first through the sharded model's ``prefill`` / ``decode_step`` on a
    (1, 1) mesh (``spmd.build``), flash launches counted from zero, then
    through ``model.prefill_fn`` / ``decode_fn`` on the same weights,
    counted again. Returns each run's logits, tokens, caches, launches
    and seconds."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as PM
    from repro_torch.parallel import spmd
    gc.collect()
    torch.cuda.empty_cache()
    whole = PM.init_params(cfg, 0, dev)
    mesh = make_mesh(("data", "model"), (1, 1))
    # on (1, 1) the rank's block of every parameter is the whole tensor:
    # shard_state's cut without its copy, which would not fit beside the
    # two models of jamba's cut (26.6 GB each)
    model = spmd.build(cfg, mesh, dev, {
        n: p.detach() for n, p in whole.named_parameters()})
    sides = {"sharded": (lambda b, n: model.prefill(b, n),
                         model.decode_step),
             "plain": (lambda b, n: PM.prefill_fn(cfg, whole, b,
                                                  cache_len=n),
                       lambda c, t, pos: PM.decode_fn(cfg, whole, c, t,
                                                      pos))}
    runs = {}
    for name, (prefill, decode) in sides.items():
        logits, tokens, caches = [], [], []
        torch.cuda.synchronize()
        fa.launches = 0                     # this side's serving path
        t0 = time.perf_counter()
        with torch.no_grad():
            for prompt in prompts:
                lg, cache = prefill(prefill_batch(cfg, prompt, dev),
                                    len(prompt) + DRYRUN_SERVE_STEPS)
                steps = [lg]
                for i in range(DRYRUN_SERVE_STEPS):
                    tok = lg.argmax(-1)
                    tokens.append(tok)
                    lg, cache = decode(cache, tok, len(prompt) + i)
                    steps.append(lg)
                logits.append(steps)
                caches.append(cache)
        torch.cuda.synchronize()
        runs[name] = dict(logits=logits, tokens=tokens, caches=caches,
                          launches=fa.launches,
                          seconds=time.perf_counter() - t0)
    del model, whole
    return runs


def phase_dryrun_serve(fa, ops, get_config, dev="cuda"):
    """The serving dry run and the sharded serving step. Six processes
    start together: DRYRUN_SERVE_ARCH's production cells at
    DRYRUN_SERVE_SHAPES and DRYRUN_SERVE_LONG's cell on
    ``single_pod_16x16`` (a fake group of 256 ranks), through the CLI on
    fake CUDA tensors and on fake CPU tensors; each CUDA record must
    equal the CPU's figures (DRYRUN_RECORD_KEYS) exactly, with no flash
    launch. Meanwhile the flash op's dispatch is timed
    (:func:`flash_dispatch`), and on a (1, 1) mesh of one NCCL rank each
    arch of DRYRUN_SERVE_WORLD1 is served through the sharded step and
    the plain one (:func:`sharded_serve`): logits, greedy tokens and
    every cache bit for bit, and the same flash launches, one an
    attention layer and prefill (an encoder-decoder's: each encoder
    layer and the decoder's self and cross attention). Returns the
    sharded path's launches by arch."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_serve_"))
    cells = [(DRYRUN_SERVE_ARCH, shape) for shape in DRYRUN_SERVE_SHAPES] \
        + [DRYRUN_SERVE_LONG]
    procs = {(arch, shape, d): dryrun_process(
        out / d, "--arch", arch, "--shape", shape, "--mesh", "single",
        dev=d)
        for arch, shape in cells for d in (dev, "cpu")}
    dispatch = flash_dispatch(fa, ops, dev)
    emit(phase="flash_op_dispatch", shape=[1, 16, 2, FLASH_DISPATCH_S,
                                           FLASH_DISPATCH_S, 128],
         calls=FLASH_DISPATCH_CALLS, **dispatch)
    init_dir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{init_dir}/init",
                            rank=0, world_size=1)
    launches, t_arch = {}, [time.perf_counter()]
    try:
        for arch in DRYRUN_SERVE_WORLD1:
            cfg = family_config(get_config, arch, TRAIN_FAMILY_LAYERS)
            prompts = serve_prompts(cfg.vocab)
            if arch != SERVE_ARCH:
                prompts = prompts[:DRYRUN_SERVE_FAMILY_PROMPTS.get(
                    arch, FAMILY_REQUESTS)]
            runs = sharded_serve(fa, cfg, prompts, dev)
            t_arch.append(time.perf_counter())
            sh, pl = runs["sharded"], runs["plain"]
            logits_equal = all(torch.equal(a, b) for x, y in zip(
                sh["logits"], pl["logits"]) for a, b in zip(x, y))
            caches_equal = all(torch.equal(x[n], y[n]) for x, y in zip(
                sh["caches"], pl["caches"]) for n in y)
            tokens_equal = all(torch.equal(a, b) for a, b in zip(
                sh["tokens"], pl["tokens"]))
            want = attention_layers(cfg) * len(prompts)
            launches[arch] = sh["launches"]
            emit(phase="dryrun_serve_world1", arch=arch, backend="nccl",
                 mesh=[1, 1], n_layers=cfg.n_layers,
                 caches=sorted(sh["caches"][0]),
                 prompt_lens=[len(p) for p in prompts],
                 decode_steps=DRYRUN_SERVE_STEPS,
                 logits_equal=logits_equal, caches_equal=caches_equal,
                 tokens_equal=tokens_equal,
                 tokens=[int(t) for t in sh["tokens"]],
                 flash_launches=sh["launches"],
                 plain_flash_launches=pl["launches"], want_launches=want,
                 sharded_s=sh["seconds"], plain_s=pl["seconds"],
                 seconds=t_arch[-1] - t_arch[-2])
            check(logits_equal and caches_equal and tokens_equal,
                  f"{arch}: the sharded prefill and decode differ from "
                  "prefill_fn / decode_fn")
            check(sh["launches"] == pl["launches"] == want,
                  f"{arch}: flash launches {sh['launches']} sharded, "
                  f"{pl['launches']} plain, want {want}")
            del runs, sh, pl
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(init_dir, ignore_errors=True)
    t1 = time.perf_counter()
    logs = {}
    try:
        for key, p in procs.items():
            logs[key] = p.communicate(timeout=max(
                DRYRUN_TIMEOUT_S - (time.perf_counter() - t0), 1))[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wait_s = time.perf_counter() - t1
    failed = {f"{a} {s} {d}": logs.get((a, s, d), "")[-3000:]
              for (a, s, d), p in procs.items() if p.returncode != 0}
    check(not failed, f"serving dry-run processes failed: {failed}")
    for arch, shape in cells:
        name = f"{arch}__{shape}__single_pod_16x16.json"
        rec, cpu = (json.loads((out / d / name).read_text())
                    for d in (dev, "cpu"))
        diff = [k for k in DRYRUN_RECORD_KEYS if rec[k] != cpu[k]]
        emit(phase="dryrun_serve_cell", arch=arch, shape=shape,
             mesh=rec["mesh"], chips=rec["chips"], kind=rec["kind"],
             collectives={k: {"count": v["count"],
                              "wire_bytes": v["wire_bytes"],
                              "operand_bytes": v["operand_bytes"]}
                          for k, v in rec["collectives"].items()},
             wire_bytes_per_dev=rec["wire_bytes_per_dev"],
             flops_per_dev=rec["flops_per_dev"],
             bytes_per_dev=rec["bytes_per_dev"], memory=rec["memory"],
             terms=rec["terms"], useful_flop_ratio=rec["useful_flop_ratio"],
             flash_launches=rec["flash_launches"],
             trace_s=rec["trace_s"], cpu_trace_s=cpu["trace_s"],
             device=rec["device"], equal_to_cpu=not diff, differ=diff)
        check(not diff, f"{arch} {shape}: the card's fake record differs "
              f"from the CPU's in {diff}")
        check(rec["flash_launches"] == 0 and rec["collectives"]
              and rec["memory"]["peak_live_bytes"]
              > rec["memory"]["argument_bytes"],
              f"{arch} {shape}: an empty record or a flash launch")
    shutil.rmtree(out, ignore_errors=True)
    emit(phase="dryrun_serve_seconds", seconds=time.perf_counter() - t0,
         world1_s=dict(zip(DRYRUN_SERVE_WORLD1, np.diff(t_arch).tolist())),
         waited_for_processes_s=wait_s)
    return launches


def jsonable(x):
    """``x`` with numpy scalars and arrays, tuples and non-string keys
    made plain for ``json.dumps``."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(fa, mp, PT, route_pod, PipelineConfig,
                   e2e_steps=EXAMPLE_E2E_STEPS,
                   quickstart_spec=EXAMPLE_QUICKSTART_SPEC, dev="cuda"):
    """The four torch examples in this process, at their counterparts'
    settings, each through its ``main`` with the kernels' counts from
    zero: quickstart through its ``run`` on ``quickstart_spec`` (its
    counterpart's 4x4x8 cut for the time limit), fault_tolerant_pod
    whole, serve_batched's defaults, train_e2e at its docstring's full
    model (``--d-model 768``) for ``e2e_steps`` steps. Their own asserts
    hold; quickstart's
    route equals a CPU ``route_pod`` of the fabric it synthesized;
    fault_tolerant_pod's network half (re-route, repair and the four
    patterns' delivered and offered rates) equals a CPU run of the same
    calls. ``dev`` must be the card (the examples' default); another
    device is passed as ``--device`` for a rehearsal. Returns each
    example's minplus hop and flash launches."""
    argv = [] if dev == "cuda" else ["--device", str(dev)]
    launches, seconds = {}, {}

    def run(name, *args, call=None):
        mp.launches = mp.hop_launches = fa.launches = 0
        t0 = time.perf_counter()
        mod = load_example(name)
        out = call(mod) if call else mod.main(argv + list(args))
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = dict(minplus_hops=mp.hop_launches,
                              minplus_f32=mp.launches,
                              flash_attention=fa.launches)
        gc.collect()
        torch.cuda.empty_cache()
        return mod, out

    _, qs = run("torch_quickstart",
                call=lambda mod: mod.run(quickstart_spec, device=dev))
    topo = PT.Topology(PT.Pod(qs["spec"]), [tuple(e) for e in qs["optical"]])
    cpu = route_pod(topo, PipelineConfig(
        robust=True, K=4, engine="array", local_search_rounds=3,
        vc="inplace", verify=True), device="cpu")
    qs_cpu = dict(n_routed=int(cpu.table.n_routed()), l_max=cpu.l_max,
                  vc_counts=cpu.vc_counts.tolist(),
                  deadlock_free=bool(cpu.deadlock_free))
    emit(phase="example", name="torch_quickstart",
         seconds=seconds["torch_quickstart"],
         launches=launches["torch_quickstart"], result=jsonable(qs),
         cpu_route=qs_cpu)
    check({k: qs[k] for k in qs_cpu} == qs_cpu,
          f"quickstart's route on the card differs from the CPU's: "
          f"{ {k: qs[k] for k in qs_cpu} } against {qs_cpu}")

    ftp_mod, ftp = run("torch_fault_tolerant_pod")
    t0 = time.perf_counter()
    ftp_cpu = ftp_mod.network("cpu")
    cpu_s = time.perf_counter() - t0
    keys = ("certificate", "fault_color", "dead_channels", "unreachable",
            "l_max_base", "l_max_fault", "flows_rerouted", "n_flows",
            "l_max_repair", "sims")
    differ = [k for k in keys if ftp[k] != ftp_cpu[k]]
    emit(phase="example", name="torch_fault_tolerant_pod",
         seconds=seconds["torch_fault_tolerant_pod"],
         launches=launches["torch_fault_tolerant_pod"], result=jsonable(ftp),
         cpu_network=jsonable({k: ftp_cpu[k] for k in keys}),
         cpu_network_s=cpu_s, differ_from_cpu=differ)
    check(not differ, f"fault_tolerant_pod on the card differs from the "
          f"CPU in {differ}")

    _, sv = run("torch_serve_batched")
    emit(phase="example", name="torch_serve_batched",
         seconds=seconds["torch_serve_batched"],
         launches=launches["torch_serve_batched"],
         result=jsonable({k: v for k, v in sv.items() if k != "results"}),
         streams=jsonable(sv["results"]))
    check(sv["served"] == 8, f"serve_batched served {sv['served']} of 8")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_e2e_") as d:
        _, e2e = run("torch_train_e2e", "--d-model", "768", "--steps",
                     str(e2e_steps), "--ckpt-dir", d)
    times = e2e["step_times"]
    emit(phase="example", name="torch_train_e2e",
         seconds=seconds["torch_train_e2e"],
         launches=launches["torch_train_e2e"], d_model=768,
         steps=e2e_steps, full_steps=300, n_params=e2e["n_params"],
         losses_first_last=[e2e["losses"][0], e2e["losses"][-1]],
         losses=e2e["losses"][::10], final_step=e2e["final_step"],
         stragglers=e2e["stragglers"],
         median_step_s=statistics.median(times[1:]),
         # train_e2e's --batch and --seq defaults
         tokens_per_s=8 * 128 / statistics.median(times[1:]))
    check(e2e["final_step"] == e2e_steps,
          f"train_e2e ended at step {e2e['final_step']} of {e2e_steps}")

    emit(phase="examples", seconds=seconds, launches=launches,
         total_s=sum(seconds.values()))
    check(launches["torch_quickstart"]["minplus_hops"] > 0,
          "quickstart's route never launched the minplus hop kernel")
    check(launches["torch_fault_tolerant_pod"]["minplus_hops"] > 0,
          "fault_tolerant_pod never launched the minplus hop kernel")
    check(launches["torch_serve_batched"]["flash_attention"] > 0,
          "serve_batched's prefills never launched the flash kernel")
    check(launches["torch_train_e2e"]["flash_attention"] == 0
          and launches["torch_fault_tolerant_pod"]["flash_attention"] == 0,
          f"training launched the flash kernel: {launches}")
    return launches


def busy_share(fn, reps: int = 1, by_kernel: bool = False,
               tags=()) -> dict:
    """Device busy share of ``reps`` calls of ``fn`` after one warm-up:
    the union of their CUDA kernels' time intervals in a profiler trace,
    over the calls' host wall time. With ``by_kernel``, also the device
    time of each kernel name from ``key_averages()`` (the 12 longest, in
    ms) and the flash kernel's share of all device time. With ``tags``,
    the device time (ms) of the kernels launched inside each profiler
    range of those names (see :func:`tagged`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()                                                     # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the raw trace, not prof.events(): building the event tree takes
    # tens of seconds for a sweep's hundreds of thousands of events
    # a profiler range also shows on the device timeline, under its name,
    # from its first kernel's start to its last's end: not a kernel
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and e.name() not in tags)
    busy, end = 0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    out = dict(wall_s=wall, device_busy_s=busy / 1e9,
               busy_share=busy / 1e9 / wall, kernels=len(spans))
    if by_kernel:
        times = {e.key: e.self_device_time_total / 1e3
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.key not in tags}
        total = sum(times.values())
        flash = sum(t for k, t in times.items() if "flash_fwd" in k)
        top = sorted(times.items(), key=lambda kv: -kv[1])[:12]
        out.update(device_ms=total, flash_ms=flash,
                   flash_share=flash / total if total else None,
                   top_kernels_ms=[[k[:120], t] for k, t in top])
    if tags:
        ms = dict.fromkeys(tags, 0.0)
        for e in prof.events():
            if e.name in ms and e.device_type == DeviceType.CPU:
                ms[e.name] += e.device_time_total / 1e3
        out["tag_device_ms"] = ms
    return out


@contextlib.contextmanager
def tagged(mod, names):
    """While the block runs, each function ``names`` of module ``mod``
    runs inside a profiler range of its name (the port calls them through
    the module, so the ranges catch every call)."""
    from torch.profiler import record_function
    saved = {n: getattr(mod, n) for n in names}

    def wrap(name, fn):
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner
    for n, fn in saved.items():
        setattr(mod, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(mod, n, fn)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch import convert
    from repro_torch.configs.registry import get_config
    from repro_torch.core import chaos as PX, fault as PF, lp as PL, \
        mcf as MC, netsim as PNS, repair as PR, synthesis as PS, \
        topology as PT, traffic as TR, workload as PW
    from repro_torch.core.pipeline import PipelineConfig, route_pod
    from repro_torch.kernels import csr_spmv as KS, \
        flash_attention as fa, minplus as mp, nvcc, ops, ref
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import layers as L, model as PM

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # one FP32 instruction per lane per clock: (min,+) has no FMA, so this
    # is half the published FP32 FLOP/s, which counts an FMA as two
    ops_per_s = sm_clock_hz * sms * FP32_LANES_PER_SM
    bf16_flops_per_s = sm_clock_hz * sms * BF16_FLOPS_PER_SM_CLOCK
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, capability=list(torch.cuda.get_device_capability(0)),
         nvidia_smi=card, max_sm_clock_mhz=sm_clock_hz / 1e6, sms=sms,
         fp32_instr_per_s=ops_per_s, bf16_flops_per_s=bf16_flops_per_s,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    # the SSD's float32 einsums must not round to TF32 (the CPU does not)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    print(card, flush=True)

    # one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(k.library) for k in (mp, fa, KS)]:
            f.result()
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds={"minplus": mp.build_seconds,
                       "flash_attention": fa.build_seconds,
                       "csr_spmv": KS.build_seconds})
    emit(phase="csr_spmv_build", ptxas=[
        line.strip() for line in nvcc.LOGS.get("csr_spmv", "").splitlines()
        if "Used" in line or "spill" in line])
    sass = sass_counts(fa.library()._name)
    ptxas = [line.strip() for line in
             nvcc.LOGS.get("flash_attention", "").splitlines()
             if "ptxas" in line or "spill" in line]
    emit(phase="flash_build", ptxas=ptxas, sass_counts=sass)
    check(ptxas, "no ptxas report for the flash library")
    check(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
          f"flash library has no wgmma or TMA loads: {sass}")

    phase_minplus_build(mp, nvcc)
    dpx_per_s = phase_minplus_probe(mp, sm_clock_hz, sms)
    tons = convert.load_fabric(
        ROOT / "benchmarks" / "results" / "tons_256.pkl", (4, 8, 8),
        name="TONS_SYM 256")
    rows, max_err, hop_err = phase_kernels(mp, ops, ref, PT, tons, ops_per_s,
                                           dpx_per_s)

    # ---- the main path, counts from zero -----------------------------------
    mp.launches = mp.hop_launches = 0
    rp8 = drive("PT 8x8x8", PT.pt((8, 8, 8)), PNS, route_pod)
    hops_8 = mp.hop_launches
    rp_tons = drive("TONS_SYM 256", tons, PNS, route_pod)
    launches, hop_launches = mp.launches, mp.hop_launches
    emit(phase="launches", minplus_hops_after_pt8=hops_8,
         minplus_hops_main_path=hop_launches, minplus_f32_main_path=launches)
    check(hops_8 > 0, "route_pod(PT 8^3) never launched the hop path")
    check(hop_launches > hops_8, "TONS_SYM 256 never launched the hop path")

    # ---- where a sweep's time goes: device busy share under the profiler ----
    rates = [0.03 * (i + 1) for i in range(10)]
    prof = busy_share(lambda: PNS.sweep(rp8.tables, rates, cycles=512,
                                        warmup=256, device="cuda"))
    emit(phase="sweep_profile", fabric="PT 8x8x8", lanes=10, cycles=512,
         kernels_per_cycle=prof["kernels"] / 512, **prof)

    # ---- the simulator is deterministic across devices ---------------------
    rp = route_pod(PT.pt((4, 4, 8)), device="cuda")
    rates = [0.02, 0.08, 0.2, 0.6]
    on_gpu = PNS.sweep(rp.tables, rates, cycles=1200, warmup=400,
                       device="cuda")
    on_cpu = PNS.sweep(rp.tables, rates, cycles=1200, warmup=400,
                       device="cpu")
    check(on_gpu == on_cpu, "CUDA and CPU sweeps differ at 4x4x8")
    emit(phase="device_determinism", fabric="PT 4x4x8", rates=rates,
         cycles=1200, equal=True)

    # ---- the fault-tolerant path, counts from zero --------------------------
    mp.launches = mp.hop_launches = 0
    t = [time.perf_counter()]
    phase_sim_modes(PNS, PT, PF, TR, route_pod, PipelineConfig)
    t.append(time.perf_counter())
    phase_fault_sweep(PNS, PT, PF, TR, route_pod, PipelineConfig)
    t.append(time.perf_counter())
    hops_repair = phase_repair(PR, PF, PT, mp)
    t.append(time.perf_counter())
    hops_chaos = phase_chaos(PR, PX, PT, mp)
    t.append(time.perf_counter())
    fault_launches, fault_f32 = mp.hop_launches, mp.launches
    emit(phase="fault_path_launches", minplus_hops=fault_launches,
         minplus_f32=fault_f32, minplus_hops_repair=hops_repair,
         minplus_hops_chaos_8=hops_chaos,
         phase_s=dict(zip(("sim_modes_determinism", "fault_sweep",
                           "repair", "chaos_8"), np.diff(t).tolist())),
         seconds=t[-1] - t[0])
    check(hops_chaos > 0, "the chaos build never launched the hop kernel")

    # ---- synthesis and workload co-design: the kernel first, then the path -
    t = [time.perf_counter()]
    dadd_cycles, dadd_s = phase_spmv_probe(KS, sm_clock_hz)
    spmv_rows, spmv_err = phase_spmv_parity(KS, ref, PL, PS, PT, dadd_s)
    phase_pdhg_determinism(KS, PL, PS, PT)
    t.append(time.perf_counter())
    KS.launches = mp.launches = mp.hop_launches = 0
    synth, ee, solves = phase_synthesis(PS, MC)
    hops_synth = mp.hop_launches
    spmv_synth = KS.launches
    synth_iters = sum(s["iters"] for s in synth.stats["solves"])
    t.append(time.perf_counter())
    phase_workload(PW, convert, PipelineConfig)
    t.append(time.perf_counter())
    spmv_launches, synth_hops = KS.launches, mp.hop_launches
    emit(phase="synthesis_path_launches", csr_spmv=spmv_launches,
         csr_spmv_synthesis=spmv_synth, minplus_hops=synth_hops,
         minplus_hops_synthesis=hops_synth,
         minplus_hops_workload=synth_hops - hops_synth,
         minplus_f32=mp.launches,
         tons_sym_256_stored=dict(l_max=rp_tons.l_max,
                                  avg_hops=rp_tons.avg_hops),
         synthesized_4x8x8=dict(l_max=ee["l_max"], avg_hops=ee["avg_hops"]))
    check(spmv_synth == 2 * synth_iters > 0,
          f"synthesis: {spmv_synth} csr_spmv launches for {synth_iters} "
          "PDHG iterations")
    check(hops_synth > 0 and synth_hops > hops_synth,
          "synthesis or workload evaluation never launched the hop path")
    phase_synthesis_repeat(PL, solves)
    phase_pdhg_chunk(KS, PL, solves[0])
    phase_workload_determinism(PW, PNS, convert, PipelineConfig, route_pod)
    t.append(time.perf_counter())
    emit(phase="synthesis_path_seconds", phase_s=dict(zip(
        ("spmv_probe+parity+pdhg_determinism", "synthesis_4x8x8",
         "workload_128", "repeat+chunk+determinism"), np.diff(t).tolist())),
         seconds=t[-1] - t[0])

    # ---- the serving path: flash kernel first, then the main path ----------
    cfg = get_config(SERVE_ARCH).model
    prompts = serve_prompts(cfg.vocab)
    prompt_lens = sorted({len(p) for p in prompts})
    family_lens = sorted({len(p) for p in prompts[:FAMILY_REQUESTS]})
    flash_rows, flash_err = phase_flash(fa, ref, prompt_lens, family_lens,
                                        bf16_flops_per_s)
    flash_launches, params = phase_serve(fa, PM, Request, Server, cfg)
    torch.cuda.empty_cache()
    long_launches = phase_prefill_long(fa, PM, cfg, params)
    del params
    torch.cuda.empty_cache()
    phase_serve_cpu_vs_gpu(PM, cfg)

    # ---- the other families' serving paths, each counted from zero --------
    family_launches = {}
    t = [time.perf_counter()]
    for arch in FAMILY_ARCHS:
        fcfg = family_config(get_config, arch)
        family_launches[arch] = phase_serve_family(fa, PM, L, Request,
                                                   Server, fcfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_family_cpu_vs_gpu(PM, L, get_config, fcfg)
        gc.collect()
        torch.cuda.empty_cache()
        t.append(time.perf_counter())
    emit(phase="serve_family_seconds",
         phase_s=dict(zip(FAMILY_ARCHS, np.diff(t).tolist())),
         seconds=t[-1] - t[0])

    # ---- the training path: flash launches counted from zero, must stay 0 -
    t = [time.perf_counter()]
    tcfg = get_config(TRAIN_ARCH).model
    trainer, train_launches, train_losses, full_figures = phase_train_full(
        fa, tcfg, bf16_flops_per_s)
    t.append(time.perf_counter())
    long_launches_train, long_figures = phase_train_long(
        fa, trainer, tcfg, bf16_flops_per_s)
    train_launches += long_launches_train
    plain_params = {n: p.detach().cpu()
                    for n, p in trainer.model.named_parameters()}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    remat_dots_launches = phase_remat_dots(
        fa, tcfg, plain_params, full_figures, long_figures, train_losses,
        bf16_flops_per_s)
    del plain_params
    t.append(time.perf_counter())
    phase_train_cpu_vs_gpu(get_config)
    phase_train_resume(get_config)
    t.append(time.perf_counter())

    # ---- the other families' training, each counted from zero, must be 0 --
    family_train_launches, family_figures = {}, {}
    for arch in TRAIN_FAMILY_ARCHS:
        family_train_launches[arch], family_figures[arch] = \
            phase_train_family_full(
                fa, PM, family_config(get_config, arch, TRAIN_FAMILY_LAYERS),
                bf16_flops_per_s)
        gc.collect()
        torch.cuda.empty_cache()
        t.append(time.perf_counter())
    phase_train_family_cpu_vs_gpu(get_config, L)
    for arch in TRAIN_FAMILY_RESUME:
        phase_train_resume(get_config, arch=arch,
                           phase="train_family_resume")
    phase_ssd_grad_128(L)
    t.append(time.perf_counter())
    parallel_launches = phase_parallel(
        fa, PM, L, get_config, train_losses, bf16_flops_per_s,
        family_figures.get("deepseek-moe-16b"))
    dryrun_launches = phase_dryrun(
        fa, get_config, train_losses,
        {a: family_figures.get(a, {}).get("losses")
         for a in DRYRUN_WORLD1_ARCHS})
    dryrun_serve_launches = phase_dryrun_serve(fa, ops, get_config)

    # ---- the torch examples, each counted from zero ------------------------
    example_launches = phase_examples(fa, mp, PT, route_pod, PipelineConfig)

    emit(phase="train_seconds", phase_s=dict(zip(
        ("train_full", "train_long", "remat_dots", "cpu_vs_gpu+resume")
        + tuple(f"family_full {a}" for a in TRAIN_FAMILY_ARCHS)
        + ("family cpu_vs_gpu+resume+ssd_grad_128",),
        np.diff(t).tolist())), seconds=t[-1] - t[0])

    def minplus_entry(path, name, launches, err):
        k = rows[path][512]
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/minplus.cu",
            "replaces": "src/repro/kernels/minplus.py:24", "path": path,
            "launches": launches, "parity": "exact", "max_abs_err": err,
            "shape": [512, 512, 512], "ms": k["ms"],
            "device_ms": k["device_ms"],
            "device_ms_source": k["device_ms_source"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,
            "device_ms_by_n": {n: r["device_ms"]
                               for n, r in rows[path].items()},
            "device_ms_source_by_n": {n: r["device_ms_source"]
                                      for n, r in rows[path].items()}}

    f = flash_rows[128][2048]
    print(json.dumps({"kernels": [
        minplus_entry("f32", "minplus", launches, max_err),
        dict(minplus_entry("hops", "minplus_hops", hop_launches, hop_err),
             launches_fault_path=fault_launches,
             launches_synthesis_path=synth_hops,
             launches_examples={k: v["minplus_hops"] for k, v in
                                example_launches.items()}), {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:24",
        "launches": flash_launches,
        "launches_prefill_long": long_launches,
        "launches_serve_family": family_launches,
        "launches_training": train_launches,
        "launches_training_families": family_train_launches,
        "launches_parallel": parallel_launches,
        "launches_dryrun": dryrun_launches,
        "launches_dryrun_serve": dryrun_serve_launches,
        "launches_remat_dots": remat_dots_launches,
        "launches_examples": {k: v["flash_attention"] for k, v in
                              example_launches.items()},
        "parity": "rtol=atol=2e-5 f32, 2e-2 bf16",
        "max_abs_err": flash_err[torch.bfloat16],
        "max_abs_err_f32": flash_err[torch.float32],
        "shape": [1, 16, 2, 2048, 2048, 128],
        "ms": f["ms"], "plain_ms": f["plain_ms"],
        "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
        "library_ms": f["library_ms"],
        "ms_by_S": {S: r["ms"] for S, r in flash_rows[128].items()},
        "library_ms_by_S": {S: r["library_ms"]
                            for S, r in flash_rows[128].items()},
        "by_head_dim": {hd: {"shape": [1, Hq, Hkv, "S", "S", hd],
                             "by_S": flash_rows[hd]}
                        for hd, (Hq, Hkv, _) in FLASH_TIME.items()
                        if hd != 128}}, {
        "name": "csr_spmv_f64", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/csr_spmv.cu",
        "replaces": "src/repro/core/lp.py:94", "launches": spmv_launches,
        "launches_synthesis": spmv_synth,
        "parity": "exact vs the plain version on the CPU",
        "max_abs_err": spmv_err, "shape": "A^T y of the 4x8x8 synthesis LP",
        **{k: spmv_rows["AT y 4x8x8"][k] for k in (
            "ms", "device_ms", "device_ms_source", "plain_ms", "bound_ms",
            "bound_by",
            "library_ms", "order_bound_ms", "bound_share")},
        "dadd_latency_cycles": dadd_cycles,
        "by_shape": spmv_rows}]}), flush=True)
    emit(phase="total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
