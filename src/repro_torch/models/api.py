"""Model facade (``repro/models/api.py:40-111``) for the dense, VLM, MoE,
SSM, hybrid and encoder-decoder families.

``build_model(cfg)`` returns a ``Model`` with the reference's entry points:
``init``, ``loss``, ``forward``, ``init_cache``, ``decode_step`` and, for
the attention families (dense, VLM, MoE), ``init_paged_cache``,
``paged_prefill_chunk``, ``paged_prefill_state`` and ``paged_decode_step``.
The VLM family is the dense transformer with patch embeddings
(``batch["patch_embeds"]``) in front of the text; the encoder-decoder
family's ``forward`` and ``loss`` take the stub frontend's frame
embeddings (``batch["frames"]``).
Parameters are passed explicitly, as in the reference, so one set of
weights serves every caller; ``Model.forward(params, batch)`` makes the
module callable.

``input_specs``, ``cache_specs``, ``paged_cache_specs`` and
``params_specs`` (``repro/models/api.py:128-177``) give storage-less
stand-ins, meta tensors with the reference's names, shapes and dtypes,
which the dry-run (``launch/dryrun.py``) runs its programs on.
``materialize`` fills such a tree with random values from a
``torch.Generator`` (``make_batch``: ``input_specs``'s). A generator
cannot live on the meta device, so ``params_specs`` runs the seeded init
on fake CPU tensors (nothing is allocated) and takes their shapes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import tree_map_with_path
from repro_torch.models import encdec, hybrid, mamba2, moe, transformer

_FAMILY_MODULES = {"dense": transformer, "vlm": transformer, "moe": moe,
                   "ssm": mamba2, "hybrid": hybrid, "encdec": encdec}


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.module = _FAMILY_MODULES[cfg.family]

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> dict:
        """Random weights on ``generator``'s device (seed 0 on ``device``
        when no generator is given)."""
        return self.module.init_params(self.cfg, generator, device)

    def forward(self, params, batch) -> torch.Tensor:
        if self.cfg.family == "encdec":
            return self.module.forward(self.cfg, params, batch["tokens"],
                                       batch["frames"])
        if self.cfg.family == "vlm":
            return self.module.forward(self.cfg, params, batch["tokens"],
                                       patch_embeds=batch.get("patch_embeds"))
        return self.module.forward(self.cfg, params, batch["tokens"])

    def loss(self, params, batch) -> torch.Tensor:
        """The training objective on ``batch`` (tokens, labels, optional
        loss_mask; VLM: optional patch_embeds; encdec: frames)."""
        return self.module.loss_fn(self.cfg, params, batch)

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device="cuda") -> dict:
        return self.module.init_cache(self.cfg, batch, max_len, dtype, device)

    def decode_step(self, params, cache, tokens, pos, write_valid=None):
        # write_valid (the frozen-row KV-write mask of a decode horizon)
        # exists for the attention families; the recurrent, hybrid and
        # encdec families keep the plain signature, as the reference's do
        if write_valid is None:
            return self.module.decode_step(self.cfg, params, cache, tokens,
                                           pos)
        return self.module.decode_step(self.cfg, params, cache, tokens, pos,
                                       write_valid=write_valid)

    def _paged(self, name: str):
        if not hasattr(self.module, name):
            raise ValueError(
                f"family {self.cfg.family!r} has no paged decode cache "
                "(the reference pages the attention families only)")
        return getattr(self.module, name)

    def init_paged_cache(self, n_blocks: int, block_size: int, dtype=None,
                         device="cuda") -> transformer.PagedCache:
        return self._paged("init_paged_cache")(self.cfg, n_blocks,
                                               block_size, dtype, device)

    def paged_prefill_chunk(self, params, cache, tokens, start, tables,
                            state=None, cap_tokens: int = 0, n_valid=None,
                            cap_rows=None):
        """Lane-batched chunk prefill (``repro/models/api.py:99-106``):
        ``state`` is the cross-chunk carry, ``cap_tokens`` sizes the MoE
        dispatch buffers and ``cap_rows`` [P] pins each lane's capacity
        (both unused by the dense family)."""
        return self._paged("paged_prefill_chunk")(
            self.cfg, params, cache, tokens, start, tables, state,
            cap_tokens, n_valid=n_valid, cap_rows=cap_rows)

    def paged_prefill_state(self, batch: int = 1, device="cuda"):
        return self._paged("paged_prefill_state")(self.cfg, batch, device)

    def paged_decode_step(self, params, cache, tokens, pos, tables,
                          write_valid=None):
        return self._paged("paged_decode_step")(
            self.cfg, params, cache, tokens, pos, tables,
            write_valid=write_valid)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)


# ---------------------------------------------------------------------------
# input specs / batches
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras(cfg: ArchConfig, batch: int, dtype) -> Dict[str, torch.Tensor]:
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = _meta((batch, cfg.enc_seq, cfg.d_model), dtype)
    if cfg.family == "vlm":
        extras["patch_embeds"] = _meta((batch, cfg.n_patches, cfg.d_model),
                                       dtype)
    return extras


def input_specs(cfg: ArchConfig, batch: int, seq_len: int,
                mode: str = "train") -> Dict[str, torch.Tensor]:
    """Meta stand-ins for the given step's data inputs: 'train' (tokens
    and labels), 'prefill' (tokens), 'decode' (one token a row; the cache
    comes from ``cache_specs``), plus the VLM's patch embeddings or the
    encdec's frames in ``cfg.dtype``."""
    i32 = torch.int32
    dtype = getattr(torch, cfg.dtype)
    if mode == "train":
        specs = {"tokens": _meta((batch, seq_len), i32),
                 "labels": _meta((batch, seq_len), i32)}
        specs.update(_extras(cfg, batch, dtype))
        return specs
    if mode == "prefill":
        specs = {"tokens": _meta((batch, seq_len), i32)}
        specs.update(_extras(cfg, batch, dtype))
        return specs
    if mode == "decode":
        return {"tokens": _meta((batch, 1), i32)}
    raise ValueError(mode)


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The decode cache's leaves as meta tensors."""
    return build_model(cfg).init_cache(batch, max_len, device="meta")


def paged_cache_specs(cfg: ArchConfig, n_blocks: int, block_size: int
                      ) -> dict:
    """The paged (block-pool) cache's ``{"k", "v"}`` pools
    ``[L, n_blocks, block_size, Hkv, D]`` as meta tensors."""
    cache = build_model(cfg).init_paged_cache(n_blocks, block_size,
                                              device="meta")
    return {"k": cache["k"], "v": cache["v"]}


def params_specs(cfg: ArchConfig) -> dict:
    """The param tree as meta tensors (the seeded init runs on fake CPU
    tensors, so nothing is allocated at any width)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = build_model(cfg).init(
            torch.Generator(device="cpu").manual_seed(0), device="cpu")
    return tree_map_with_path(lambda _, t: _meta(t.shape, t.dtype), params)


def materialize(tree, generator: torch.Generator, vocab_size: int):
    """Tensors on ``generator``'s device of a tree of meta stand-ins'
    shapes and dtypes (dicts, lists and tuples kept): float leaves normal
    x 0.02, integer leaves uniform token ids below ``vocab_size``."""
    if isinstance(tree, dict):
        return {k: materialize(v, generator, vocab_size)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(materialize(v, generator, vocab_size)
                          for v in tree)
    t = torch.empty(tree.shape, dtype=tree.dtype, device=generator.device)
    if t.dtype.is_floating_point:
        return t.normal_(0.0, 0.02, generator=generator)
    return t.random_(0, vocab_size, generator=generator)


def make_batch(cfg: ArchConfig, batch: int, seq_len: int,
               generator: torch.Generator, mode: str = "train"
               ) -> Dict[str, torch.Tensor]:
    """A random batch matching ``input_specs`` on ``generator``'s device
    (``materialize``)."""
    return materialize(input_specs(cfg, batch, seq_len, mode), generator,
                       cfg.vocab_size)
