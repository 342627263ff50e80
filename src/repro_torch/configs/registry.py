"""Architecture registry for the port: the dense, VLM, MoE and SSM families.

The values are copies of ``repro/configs/{qwen2_0_5b,llama3_2_1b,
gemma3_27b,qwen2_7b,phi3_vision,olmoe_1b_7b,mamba2_780m}.py``. Other
families of the reference registry raise ``NotImplementedError`` until
their slice of the port lands.
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
        d_ff=8192, vocab_size=32064, rope_theta=10000.0, n_patches=576),
    "olmoe-1b-7b": ArchConfig(
        arch_id="olmoe-1b-7b", family="moe", citation="arXiv:2409.02060",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1024, vocab_size=50304, n_experts=64, top_k=8,
        rope_theta=10000.0),
    "mamba2-780m": ArchConfig(
        arch_id="mamba2-780m", family="ssm", citation="arXiv:2405.21060",
        n_layers=48, d_model=1536, d_ff=0, vocab_size=50280, ssm_state=128,
        ssm_expand=2, ssm_headdim=64, ssm_chunk=256, tie_embeddings=True),
}

#: reference architectures whose families are not ported yet
_LATER = ("whisper-large-v3", "phi3.5-moe-42b-a6.6b", "zamba2-7b")

ARCH_IDS: List[str] = list(_CONFIGS)


def get_config(arch_id: str, smoke: bool = False, **overrides) -> ArchConfig:
    if arch_id in _LATER:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: its family (or, for phi3.5-moe, "
            "its sharded size) comes later (ROADMAP queue A, items 7 and 10)")
    if arch_id not in _CONFIGS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = _CONFIGS[arch_id]
    if smoke:
        cfg = smoke_variant(cfg)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
