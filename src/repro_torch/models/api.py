"""Model facade (``repro/models/api.py:40-111``) for the dense, MoE and SSM
families.

``build_model(cfg)`` returns a ``Model`` with the reference's entry points:
``init``, ``loss``, ``forward``, ``init_cache``, ``decode_step`` and, for
the dense family, ``init_paged_cache``, ``paged_prefill_chunk``,
``paged_prefill_state`` and ``paged_decode_step`` (the MoE family's paged
entry points come with the paged-MoE engine, ROADMAP queue A, item 6).
Parameters are passed explicitly, as in the reference, so one set of
weights serves every caller; ``Model.forward(params, batch)`` makes the
module callable.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2, moe, transformer

_FAMILY_MODULES = {"dense": transformer, "moe": moe, "ssm": mamba2}


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
        return self.module.forward(self.cfg, params, batch["tokens"])

    def loss(self, params, batch) -> torch.Tensor:
        """The training objective on ``batch`` (tokens, labels, optional
        loss_mask)."""
        return self.module.loss_fn(self.cfg, params, batch)

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device="cuda") -> dict:
        return self.module.init_cache(self.cfg, batch, max_len, dtype, device)

    def decode_step(self, params, cache, tokens, pos, write_valid=None):
        # write_valid (the frozen-row KV-write mask of a decode horizon)
        # exists for the attention families; recurrent state has no
        # positional write to mask, so the plain signature is kept there
        if write_valid is None:
            return self.module.decode_step(self.cfg, params, cache, tokens,
                                           pos)
        return self.module.decode_step(self.cfg, params, cache, tokens, pos,
                                       write_valid=write_valid)

    def _paged(self, name: str):
        if not hasattr(self.module, name):
            raise NotImplementedError(
                f"the {self.cfg.family} family's paged cache is ported later "
                "(ROADMAP queue A, item 6); it serves the contiguous cache")
        return getattr(self.module, name)

    def init_paged_cache(self, n_blocks: int, block_size: int, dtype=None,
                         device="cuda") -> transformer.PagedCache:
        return self._paged("init_paged_cache")(self.cfg, n_blocks,
                                               block_size, dtype, device)

    def paged_prefill_chunk(self, params, cache, tokens, start, tables,
                            state=None, n_valid=None):
        return self._paged("paged_prefill_chunk")(
            self.cfg, params, cache, tokens, start, tables, state,
            n_valid=n_valid)

    def paged_prefill_state(self, batch: int = 1):
        return self._paged("paged_prefill_state")(self.cfg, batch)

    def paged_decode_step(self, params, cache, tokens, pos, tables,
                          write_valid=None):
        return self._paged("paged_decode_step")(
            self.cfg, params, cache, tokens, pos, tables,
            write_valid=write_valid)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} is ported later (ROADMAP queue A, item "
            "7); the port covers the dense, MoE and SSM families")
    return Model(cfg)
