"""qwen2.5-3b [dense]: GQA (kv=2), QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    model=ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
        d_ff=11008, vocab=151936, act="silu", qkv_bias=True,
        rope_theta=1e6, tie_embeddings=True,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: pure full attention (dense 512k KV decode "
          "outside design envelope).",
)
