"""Architecture configuration schema (a trimmed copy of ``repro.configs.base``).

Only the fields the dense, VLM, MoE and SSM paths read are kept; the other
families' fields arrive with their slices of the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    # -- identity -----------------------------------------------------------
    arch_id: str
    family: str                      # dense | vlm | moe | ssm (ported so far)
    citation: str = ""

    # -- transformer geometry ------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    pos_emb: str = "rope"
    rope_theta: float = 10000.0

    # -- attention pattern ---------------------------------------------------
    sliding_window: int = 0          # 0 = full attention
    global_every: int = 0            # gemma3: every Nth layer is global

    # -- mixture of experts --------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- state-space (mamba2 / SSD) ------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # -- vlm ------------------------------------------------------------------
    n_patches: int = 0               # stub-frontend patch count (the
                                     # sequence's prefix)

    # -- numerics -------------------------------------------------------------
    dtype: str = "float32"           # activation dtype
    param_dtype: str = "float32"
    moe_gather_dispatch: bool = False  # MoE dispatch via int32 slot->token
                                     # indices + a gather, instead of a
                                     # scatter-add of the feature rows

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """The reference's per-arch smoke shape: same family and code paths,
    laptop-scale widths (2 layers, d_model 256, vocab 512; MoE: 4 experts,
    top-2, expert width 128; SSM: state 16, head dim 32, chunk 32; VLM: 16
    patches)."""
    kw = dict(
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, d_ff=128)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_headdim=32, ssm_chunk=32)
    if cfg.family == "vlm":
        kw.update(n_patches=16)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return cfg.replace(**kw)
