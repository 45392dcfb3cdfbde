"""Config dataclasses for models, shapes, and architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | encdec
    n_layers: int = 4
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    vocab: int = 32000
    act: str = "silu"              # silu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    causal: bool = True
    attn_block: int = 1024         # kv block for flash-style attention
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0         # leading dense layers (deepseek-moe style)
    moe_every: int = 1             # MoE on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    # --- SSM (mamba2) ---
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid (jamba): period of the mixer pattern; attn at this index ---
    hybrid_period: int = 8
    hybrid_attn_index: int = 4
    # --- encoder-decoder ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- multimodal stubs ---
    n_vision_tokens: int = 0       # VLM: patch embeddings added to prefix
    audio_frontend: bool = False   # enc-dec: encoder consumes frame embeddings
    # --- lowering ---
    unroll: bool = False           # unroll layer stacks (flops accounting)
    remat: bool = True             # rematerialise layer bodies in training
    # --- beyond-baseline optimisations (EXPERIMENTS.md section Perf) ---
    opt_moe_local_dispatch: bool = False   # shard-local MoE sort/scatter
    opt_shard_carry: bool = False          # TP-shard the saved scan carry
    opt_moe_cf1: bool = False              # capacity factor 1.25 -> 1.0
    opt_remat_dots: bool = False           # save matmul outputs in remat
    opt_microbatch4: bool = False          # 4-way grad accumulation

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def mixer_kind(self, i: int) -> str:
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            return "attn" if (i % self.hybrid_period) == self.hybrid_attn_index \
                else "mamba"
        return "attn"

    def ffn_kind(self, i: int) -> Optional[str]:
        if self.family == "ssm":
            return None
        if self.family in ("moe", "hybrid"):
            if i < self.first_k_dense:
                return "mlp"
            if (i % self.moe_every) == self.moe_offset:
                return "moe"
            return "mlp"
        return "mlp"

    def param_count(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS and reporting)."""
        D, hd = self.d_model, self.head_dim
        n = self.vocab * D * (1 if self.tie_embeddings else 2)
        enc_dec = self.family == "encdec"
        layers = (self.enc_layers + self.dec_layers) if enc_dec else self.n_layers
        for i in range(layers):
            mixer = self.mixer_kind(i) if not enc_dec else "attn"
            if mixer == "attn":
                n += D * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * D
                if enc_dec and i >= self.enc_layers:  # cross attention
                    n += D * hd * (self.n_heads + 2 * self.n_kv_heads) \
                        + self.n_heads * hd * D
            else:
                din = self.d_inner
                gn = self.ssm_groups * self.ssm_state
                n += D * (2 * din + 2 * gn + self.ssm_heads) + din * D
            ffn = self.ffn_kind(i) if not enc_dec else "mlp"
            if ffn == "mlp":
                ff = self.d_ff if not (self.family == "moe" and
                                       i < self.first_k_dense) else self.d_ff
                n += 3 * D * ff
            elif ffn == "moe":
                n += 3 * D * self.moe_d_ff * self.n_experts + D * self.n_experts
                n += 3 * D * self.moe_d_ff * self.n_shared_experts
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k)."""
        if self.family not in ("moe", "hybrid") or not self.n_experts:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.ffn_kind(i) == "moe")
        inactive = n_moe_layers * 3 * self.d_model * self.moe_d_ff * \
            (self.n_experts - self.top_k)
        return full - inactive


# ---------------------------------------------------------------------------
# Input shapes (the four assigned cells)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    model: ModelConfig
    # shapes this arch runs; long_500k only for sub-quadratic archs
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    notes: str = ""

    def smoke_model(self) -> ModelConfig:
        """Reduced config of the same family for CPU smoke tests."""
        m = self.model
        return dataclasses.replace(
            m,
            n_layers=min(m.n_layers, 2 if m.family != "hybrid"
                         else m.hybrid_period),
            d_model=256,
            n_heads=4,
            n_kv_heads=max(1, min(m.n_kv_heads, 2)) if m.n_kv_heads < m.n_heads
            else 4,
            head_dim=64,
            d_ff=512,
            vocab=512,
            moe_d_ff=128 if m.n_experts else 0,
            n_experts=min(m.n_experts, 4) if m.n_experts else 0,
            top_k=min(m.top_k, 2) if m.top_k else 0,
            n_shared_experts=min(m.n_shared_experts, 1),
            first_k_dense=min(m.first_k_dense, 1),
            ssm_state=min(m.ssm_state, 16),
            ssm_head_dim=32,
            enc_layers=min(m.enc_layers, 2),
            dec_layers=min(m.dec_layers, 2),
            n_vision_tokens=min(m.n_vision_tokens, 16),
            attn_block=64,
            ssm_chunk=16,
        )
