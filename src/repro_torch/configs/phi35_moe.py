"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    model=ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=6400, vocab=32064, act="silu", norm="layernorm",
        n_experts=16, top_k=2, moe_d_ff=6400,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: pure full attention.",
)
