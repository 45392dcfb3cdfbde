"""internvl2-2b [vlm]: InternLM2 backbone; InternViT frontend STUBBED --
``input_specs`` supplies 256 precomputed patch embeddings added to the
sequence prefix. [arXiv:2404.16821]
"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    model=ModelConfig(
        name="internvl2-2b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=92553, act="silu",
        n_vision_tokens=256, rope_theta=1e6,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: pure full attention. Vision frontend is a stub"
          " (precomputed patch embeddings) per the assignment.",
)
