"""deepseek-moe-16b [moe]: fine-grained 64 routed top-6 + 2 shared experts,
first layer dense. [arXiv:2401.06066]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    model=ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=10944, vocab=102400, act="silu",
        n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
        first_k_dense=1,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: pure full attention. Layer 0 dense (d_ff "
          "10944), layers 1-27 MoE with d_ff 1408 per expert.",
)
