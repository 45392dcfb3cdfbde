"""stablelm-12b [dense]: GQA kv=8, LayerNorm. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    model=ModelConfig(
        name="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
        d_ff=13824, vocab=100352, act="silu", norm="layernorm",
        rope_theta=10000.0,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: pure full attention. StableLM-2 uses partial "
          "rotary (25%); we apply full-dim RoPE (noted adaptation).",
)
