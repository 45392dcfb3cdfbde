"""seamless-m4t-medium [audio]: encoder-decoder; audio frontend STUBBED --
``input_specs`` supplies precomputed frame embeddings (B, S, D).
[arXiv:2308.11596]"""
from repro_torch.configs.base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    model=ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=24, enc_layers=12, dec_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab=256206, act="gelu", norm="layernorm",
        audio_frontend=True,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: pure full attention (enc-dec). Decoder-side "
          "decode_32k attends a 32k self-KV plus the 32k encoder memory.",
)
