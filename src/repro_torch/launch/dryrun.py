"""The decode cache's layout on a mesh (``repro/launch/dryrun.py:78-138``).

Only ``cache_pspecs`` and its helpers are ported here, for the serve
sharding plan (``serve/sharded.py``). The rest of the reference module,
lowering every (arch x input shape x mesh) combination and reading the
roofline terms off the compiled program, is the dry-run tooling of
ROADMAP queue A, item 12.
"""
from __future__ import annotations

from repro_torch.dist.sharding import Spec as P, tree_map_with_path
from repro_torch.launch.mesh import axis_sizes


def _batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _div(n: int, size: int) -> bool:
    return n % size == 0 and n > 0


def cache_pspecs(cfg, cache_shape, mesh, *, seq_shard: bool, batch: int,
                 paged: bool = False):
    """Specs for the decode cache, per family (leaves: tensors or shapes,
    matched by their '/'-joined path).

    KV head counts that do not divide the model axis fall back to sharding
    the cache SEQ dimension over 'model'. ``paged=True`` describes the
    block-pool layout ``[L, n_blocks, block_size, kv, hd]`` instead: the
    block dimension stays unsharded (any slot's table may name any block),
    KV heads shard over 'model', and the small-KV-head fallback shards the
    in-block position dimension."""
    ba = _batch_axes(mesh)
    bsz = 1
    for a in ba:
        bsz *= axis_sizes(mesh)[a]
    b_ax = ba if _div(batch, bsz) else None
    msize = axis_sizes(mesh)["model"]

    def spec_for(path, leaf):
        name = "/".join(str(p) for p in path)
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        ndim = len(shape)

        def m_ax(dim):
            return "model" if _div(shape[dim], msize) else None
        if paged and name in ("k", "v"):
            # [L, NB, BS, kv, hd]
            s_ax = ("model" if m_ax(3) is None and _div(shape[2], msize)
                    else None)
            return P(None, None, s_ax, m_ax(3), None)
        if name in ("k", "v") or name.endswith(("attn_k", "attn_v")):
            # [L_or_G, B, S, kv, hd]
            if seq_shard:
                s_ax = "data"
            elif m_ax(3) is None and _div(shape[2], msize):
                s_ax = "model"
            else:
                s_ax = None
            return P(None, b_ax, s_ax, m_ax(3), None)
        if name in ("ck", "cv"):
            return P(None, b_ax, None, m_ax(3), None)
        if name.endswith("conv") and ndim == 4:     # [L,B,K-1,ch]
            return P(None, b_ax, None, m_ax(3))
        if name.endswith("conv") and ndim == 5:     # [G,E,B,K-1,ch]
            return P(None, None, b_ax, None, m_ax(4))
        if name.endswith("ssm") and ndim == 5:      # [L,B,H,N,P]
            return P(None, b_ax, m_ax(2), None, None)
        if name.endswith("ssm") and ndim == 6:      # [G,E,B,H,N,P]
            return P(None, None, b_ax, m_ax(3), None, None)
        return P()

    return tree_map_with_path(spec_for, cache_shape)
