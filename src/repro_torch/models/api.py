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
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
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
