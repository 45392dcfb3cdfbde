"""Build a hand-written CUDA source into a shared library at first use.

Each kernel in ``csrc/`` has a plain C entry point and no PyTorch
headers, so ``nvcc`` builds it in seconds. :func:`build` compiles one
source for ``sm_90a`` into ``build/`` beside this file, named by the
library name and a hash of the source (an edited kernel rebuilds), and
returns the path with the seconds ``nvcc`` took (``None`` when the
library was already built). nvcc's output, with ptxas's report of each
kernel's registers, spills and shared memory, is written beside the
library as ``.log`` and kept in ``LOGS``, read back from there when the
library was built before. The caller loads it with ctypes.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LOGS: Dict[str, str] = {}  # nvcc's output of each library built or found


def nvcc_path() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path}); "
                           "the CUDA toolkit is needed to build the kernel")
    return path


def build(source: Path, name: str) -> Tuple[Path, Optional[float]]:
    """``build/lib{name}-{hash}.so`` from ``source``, compiled if missing.

    Raises with nvcc's output when the compile fails. Safe to call from
    several processes or threads at once: each compiles into its own
    temporary directory and renames the result into place.
    """
    src = source.read_bytes()
    so = BUILD_DIR / f"lib{name}-{hashlib.sha1(src).hexdigest()[:12]}.so"
    log = so.with_suffix(".log")
    if so.exists():
        LOGS[name] = log.read_text() if log.exists() else ""
        return so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / so.name
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        LOGS[name] = proc.stdout + proc.stderr
        (Path(tmp) / log.name).write_text(LOGS[name])
        os.replace(Path(tmp) / log.name, log)
        os.replace(out, so)
    return so, time.perf_counter() - t0
