"""Architecture registry: --arch <id> resolution."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeConfig

_MODULES = {
    "qwen2.5-3b": "repro_torch.configs.qwen25_3b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_27b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {list_archs()}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped cells flagged."""
    out = []
    for a in list_archs():
        cfg = get_config(a)
        for s in SHAPES:
            runnable = s in cfg.shapes
            if runnable or include_skipped:
                out.append((a, s, runnable))
    return out
