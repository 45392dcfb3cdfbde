"""qwen1.5-32b [dense]: MHA-equivalent GQA (kv=40), QKV bias."""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    model=ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
        d_ff=27392, vocab=152064, act="silu", qkv_bias=True,
        rope_theta=1e6,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: pure full attention.",
)
