"""mamba2-2.7b [ssm]: attention-free SSD. [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    model=ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab=50280, tie_embeddings=True,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    notes="long_500k runs: SSM decode is O(1)-state (no KV cache).",
)
