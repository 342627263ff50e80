"""Model facade (``repro/models/api.py:40-111``) for the dense family.

``build_model(cfg)`` returns a ``Model`` with the reference's entry points:
``init``, ``forward``, ``init_paged_cache``, ``paged_prefill_chunk``,
``paged_prefill_state`` and ``paged_decode_step``. Parameters are passed
explicitly, as in the reference, so one set of weights serves every
caller; ``Model.forward(params, batch)`` makes the module callable.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> dict:
        """Random weights on ``generator``'s device (seed 0 on ``device``
        when no generator is given)."""
        return transformer.init_params(self.cfg, generator, device)

    def forward(self, params, batch) -> torch.Tensor:
        return transformer.forward(self.cfg, params, batch["tokens"])

    def init_paged_cache(self, n_blocks: int, block_size: int, dtype=None,
                         device="cuda") -> transformer.PagedCache:
        return transformer.init_paged_cache(self.cfg, n_blocks, block_size,
                                            dtype, device)

    def paged_prefill_chunk(self, params, cache, tokens, start, tables,
                            state=None, n_valid=None):
        return transformer.paged_prefill_chunk(self.cfg, params, cache,
                                               tokens, start, tables, state,
                                               n_valid=n_valid)

    def paged_prefill_state(self, batch: int = 1):
        return transformer.paged_prefill_state(self.cfg, batch)

    def paged_decode_step(self, params, cache, tokens, pos, tables,
                          write_valid=None):
        return transformer.paged_decode_step(self.cfg, params, cache, tokens,
                                             pos, tables,
                                             write_valid=write_valid)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is ported later (ROADMAP queue A, "
            "items 6-7); the port covers the dense family")
    return Model(cfg)
