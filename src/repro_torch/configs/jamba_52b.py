"""jamba-v0.1-52b [hybrid]: Mamba+attn 1:7 interleave, MoE 16e top-2.

Period-8 super-block: attention at index 4, Mamba elsewhere; MoE FFN on odd
sub-layers (16 MoE layers of 32). Jamba v0.1 uses Mamba-1 (state 16); we use
the Mamba-2/SSD block with ssm_state=16 -- TPU adaptation (SSD is the
matmul/MXU-friendly formulation of the same SSM). [arXiv:2403.19887]
"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    model=ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=65536, act="silu",
        n_experts=16, top_k=2, moe_d_ff=14336, moe_every=2, moe_offset=1,
        hybrid_period=8, hybrid_attn_index=4,
        ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    notes="long_500k runs: hybrid -- only 4 of 32 layers attend (O(L) decode"
          " over the KV cache); Mamba layers carry O(1) state.",
)
