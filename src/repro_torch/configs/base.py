"""Architecture configuration schema (a trimmed copy of ``repro.configs.base``).

Only the fields the port's paths read are kept (the dense, VLM, MoE, SSM,
hybrid and encoder-decoder families).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    # -- identity -----------------------------------------------------------
    arch_id: str
    family: str                      # dense | vlm | moe | ssm | hybrid | encdec
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

    # -- hybrid (zamba2) ------------------------------------------------------
    shared_attn_every: int = 0       # shared attn block before every N ssm blocks

    # -- encoder-decoder (whisper) --------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 0                 # stub-frontend frame count

    # -- vlm ------------------------------------------------------------------
    n_patches: int = 0               # stub-frontend patch count (the
                                     # sequence's prefix)

    # -- numerics -------------------------------------------------------------
    dtype: str = "float32"           # activation dtype
    param_dtype: str = "float32"
    moe_gather_dispatch: bool = False  # MoE dispatch via int32 slot->token
                                     # indices + a gather, instead of a
                                     # scatter-add of the feature rows
    remat: str = "none"              # none | dots | full (activation
                                     # recomputation in training)
    pad_q_heads: int = 0             # pad Q heads to this count (zero
                                     # wo rows, inside each KV group) so
                                     # heads shard evenly over 'model'

    # -- Synergy workload class (the paper's Fig. 2 families) ----------------
    sens_class: str = "language"     # image | language | speech

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def n_heads_eff(self) -> int:
        """The q head count the attention layers carry: ``pad_q_heads``
        when it exceeds ``n_heads``."""
        return (self.pad_q_heads if self.pad_q_heads > self.n_heads
                else self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """The reference's analytic parameter count (``active_only``: the
        top-k experts of a MoE layer only); the dispatch profiler's
        roofline reads it."""
        d, hd = self.d_model, self.resolved_head_dim
        v = self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            q = d * self.n_heads * hd + (self.n_heads * hd if self.qkv_bias
                                         else 0)
            kv = 2 * (d * self.n_kv_heads * hd
                      + (self.n_kv_heads * hd if self.qkv_bias else 0))
            o = self.n_heads * hd * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            return 3 * d * ff          # swiglu: gate + up + down

        def moe_params() -> int:
            router = d * self.n_experts
            experts = self.n_experts if not active_only else self.top_k
            return router + experts * mlp_params(self.d_ff)

        def ssm_params() -> int:
            di, st, g = self.d_inner, self.ssm_state, self.ssm_groups
            h = self.n_ssm_heads
            in_p = d * (2 * di + 2 * g * st + h)
            conv = (di + 2 * g * st) * self.ssm_conv
            return in_p + conv + h * 2 + di + di * d  # A, dt_bias, D, norm,
                                                      # out_proj
        per_layer = 2 * d              # two norms
        if self.family in ("dense", "vlm"):
            per_layer += attn_params() + mlp_params(self.d_ff)
            total = emb + self.n_layers * per_layer
        elif self.family == "moe":
            per_layer += attn_params() + moe_params()
            total = emb + self.n_layers * per_layer
        elif self.family == "ssm":
            total = emb + self.n_layers * (d + ssm_params())
        elif self.family == "hybrid":
            shared = attn_params() + mlp_params(4 * d) + 2 * d
            total = emb + self.n_layers * (d + ssm_params()) + shared
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn_params() + mlp_params(self.d_ff)
                                       + 2 * d)
            dec = self.n_layers * (2 * attn_params() + mlp_params(self.d_ff)
                                   + 3 * d)
            total = emb + enc + dec
        else:
            raise ValueError(self.family)
        return int(total)


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """The reference's per-arch smoke shape: same family and code paths,
    laptop-scale widths, no remat (2 layers, d_model 256, vocab 512; MoE: 4 experts,
    top-2, expert width 128; SSM and hybrid: state 16, head dim 32, chunk
    32; hybrid: shared attention every 2 blocks; encdec: 2 encoder layers,
    64 frames; VLM: 16 patches)."""
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
        remat="none",
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, d_ff=128)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_headdim=32, ssm_chunk=32)
    if cfg.family == "hybrid":
        kw.update(shared_attn_every=2)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, enc_seq=64)
    if cfg.family == "vlm":
        kw.update(n_patches=16)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return cfg.replace(**kw)
