"""gemma-7b [dense]: GeGLU, head_dim=256, vocab 256000. [arXiv:2403.08295]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    model=ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000, act="gelu", tie_embeddings=True,
        rope_theta=10000.0,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: pure full attention.",
)
