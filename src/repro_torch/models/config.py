"""Model configuration: the port's own copy of ``repro/models/config.py``
(pure Python; the port imports nothing of the JAX package).  Same fields,
defaults and analytic parameter counts."""
from __future__ import annotations

import dataclasses
from typing import Optional

# block kinds
ATTN = "attn"            # global causal (or bidirectional for encoders) + MLP
ATTN_LOCAL = "attn_local"  # sliding-window attention + MLP
SSD = "ssd"              # mamba2 state-space duality block (no MLP)
RGLRU = "rglru"          # recurrentgemma RG-LRU recurrent block + MLP
MOE = "moe"              # attention + MoE MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple[str, ...]   # len == n_layers

    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: Optional[float] = None
    local_window: int = 1024
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None   # gemma3: different theta locally

    # mlp
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    use_post_norm: bool = False      # gemma3: post-attn/post-mlp norms

    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    expert_capacity_factor: float = 1.25

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # rg-lru (recurrentgemma)
    lru_width: int = 0
    conv_width: int = 4

    # embeddings / head
    tie_embeddings: bool = True
    emb_scale: bool = False          # gemma: embeddings * sqrt(d_model)
    causal: bool = True              # False -> encoder-only (hubert)
    frontend: Optional[str] = None   # None | "vision" | "audio" (stubs)
    frontend_len: int = 0            # prefix positions fed by the stub

    # numerics
    dtype: str = "bfloat16"
    vocab_pad_to: int = 128

    def __post_init__(self):
        if len(self.block_pattern) != self.n_layers:
            raise ValueError(f"block_pattern has {len(self.block_pattern)} "
                             f"kinds for {self.n_layers} layers")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return -(-self.vocab_size // p) * p

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def has_decode(self) -> bool:
        return self.causal

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        e, v = self.d_model, self.padded_vocab
        total = v * e
        if not self.tie_embeddings:
            total += v * e
        for kind in self.block_pattern:
            total += self.block_params(kind)
        total += e  # final norm
        return total

    def block_params(self, kind: str) -> int:
        e = self.d_model
        h, hk, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = e * h * hd + 2 * e * hk * hd + h * hd * e
        if self.qkv_bias:
            attn += (h + 2 * hk) * hd
        mlp_mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        mlp = mlp_mult * e * self.d_ff
        norms = 2 * e * (2 if self.use_post_norm else 1)
        if kind == ATTN or kind == ATTN_LOCAL:
            return attn + mlp + norms
        if kind == MOE:
            ff = self.d_ff_expert or self.d_ff
            moe = self.n_experts * mlp_mult * e * ff + e * self.n_experts
            moe += self.n_shared_experts * mlp_mult * e * ff
            return attn + moe + norms
        if kind == SSD:
            di, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = e * (2 * di + 2 * st + nh)
            conv = (di + 2 * st) * self.ssm_conv
            out = di * e
            return in_proj + conv + out + di + nh * 2 + e  # norm+A+D+norm
        if kind == RGLRU:
            w = self.lru_width or e
            rec = 2 * e * w + w * self.conv_width + 2 * w * w + 2 * w + w * e
            return rec + mlp + norms
        raise ValueError(kind)
