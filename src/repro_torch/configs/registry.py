"""Architecture registry for the port: the dense, VLM, MoE, SSM, hybrid
and encoder-decoder families.

The values are copies of ``repro/configs/{qwen2_0_5b,llama3_2_1b,
gemma3_27b,qwen2_7b,phi3_vision,olmoe_1b_7b,phi3_5_moe,mamba2_780m,
zamba2_7b,whisper_large_v3}.py``. phi3.5-moe does not fit one card at full
width (32 layers of 16 experts of 6400, ~166 GB in f32): it runs at smoke
size here and waits for a cell of four cards at full width.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ArchConfig, smoke_variant

_CONFIGS = {
    "qwen2-0.5b": ArchConfig(
        arch_id="qwen2-0.5b", family="dense", citation="arXiv:2407.10671",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151936, qkv_bias=True, rope_theta=1000000.0,
        tie_embeddings=True),
    "llama3.2-1b": ArchConfig(
        arch_id="llama3.2-1b", family="dense",
        citation="hf:meta-llama/Llama-3.2-1B",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
        d_ff=8192, vocab_size=128256, rope_theta=500000.0,
        tie_embeddings=True),
    "gemma3-27b": ArchConfig(
        arch_id="gemma3-27b", family="dense", citation="hf:google/gemma-3-1b-pt",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=21504, vocab_size=262144, rope_theta=1000000.0,
        sliding_window=1024, global_every=6, tie_embeddings=True),
    "qwen2-7b": ArchConfig(
        arch_id="qwen2-7b", family="dense", citation="arXiv:2407.10671",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
        d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1000000.0),
    # phi3-mini backbone; the CLIP encoder and projector are a stub: the
    # caller supplies n_patches precomputed patch embeddings, which take
    # the sequence's first positions
    "phi-3-vision-4.2b": ArchConfig(
        arch_id="phi-3-vision-4.2b", family="vlm",
        citation="hf:microsoft/Phi-3-vision-128k-instruct",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192, vocab_size=32064, rope_theta=10000.0, n_patches=576,
        sens_class="image"),
    "olmoe-1b-7b": ArchConfig(
        arch_id="olmoe-1b-7b", family="moe", citation="arXiv:2409.02060",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1024, vocab_size=50304, n_experts=64, top_k=8,
        rope_theta=10000.0),
    # 16 experts top-2; full width needs the four-card mesh
    "phi3.5-moe-42b-a6.6b": ArchConfig(
        arch_id="phi3.5-moe-42b-a6.6b", family="moe",
        citation="hf:microsoft/Phi-3.5-MoE-instruct",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=6400, vocab_size=32064, n_experts=16, top_k=2,
        rope_theta=10000.0, sens_class="language"),
    "mamba2-780m": ArchConfig(
        arch_id="mamba2-780m", family="ssm", citation="arXiv:2405.21060",
        n_layers=48, d_model=1536, d_ff=0, vocab_size=50280, ssm_state=128,
        ssm_expand=2, ssm_headdim=64, ssm_chunk=256, tie_embeddings=True),
    # 81 Mamba2 blocks; one shared attention(+MLP) block before every 6 of
    # them (13 calls, then 3 trailing blocks)
    "zamba2-7b": ArchConfig(
        arch_id="zamba2-7b", family="hybrid", citation="arXiv:2411.15242",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
        d_ff=14336, vocab_size=32000, ssm_state=64, ssm_expand=2,
        ssm_headdim=64, shared_attn_every=6),
    # 32 encoder + 32 decoder layers; the mel + conv frontend is a stub: the
    # caller supplies enc_seq precomputed frame embeddings
    "whisper-large-v3": ArchConfig(
        arch_id="whisper-large-v3", family="encdec",
        citation="arXiv:2212.04356", n_layers=32, n_enc_layers=32,
        d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64, d_ff=5120,
        vocab_size=51866, qkv_bias=True, pos_emb="sinusoidal", enc_seq=1500,
        sens_class="speech"),
}

ARCH_IDS: List[str] = list(_CONFIGS)


def get_config(arch_id: str, smoke: bool = False, **overrides) -> ArchConfig:
    if arch_id not in _CONFIGS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = _CONFIGS[arch_id]
    if smoke:
        cfg = smoke_variant(cfg)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
