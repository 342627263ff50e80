"""The hand-written kernels' costs in closed form: the FLOPs a call does and
the bytes it must move (each input read once, each output written once),
and the least time those take on one H100 (``launch/mesh.py``'s peaks).

``chip_smoke.py`` prints each kernel's bound from these formulas, and the
dry-run (``launch/dryrun.py``) books them for every kernel call on
tensors without storage (``kernels/ops.py``), so it counts the work the
card runs, not the plain versions' scores. The counts follow the data
where the work does (the paged kernels' table walk, the grouped matmul's
valid rows); without the data (a dry-run), the paged kernels count a full
table and the grouped matmul every row. The module imports neither torch
nor numpy.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.launch.mesh import F32_FLOPS, HBM_BW, PEAK_FLOPS_BF16, \
    TF32_FLOPS

#: (flops, bytes) of one call
Cost = Tuple[int, int]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def visible_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs of one head that a self-attention over ``s``
    positions sees: key j is visible from query i when ``j <= i``
    (``causal``) and ``i - j < window`` (``window`` > 0)."""
    w = window if window and window < s else 0
    if causal:
        return s * (s + 1) // 2 if not w else w * (w + 1) // 2 + (s - w) * w
    return s * s if not w else w * s + s * (s - 1) // 2 - w * (w - 1) // 2


def visible_pairs_rows(q0: int, s: int, sk: int, causal: bool,
                       window: int) -> int:
    """The (query, key) pairs of one head that ``s`` queries at positions
    ``q0 .. q0 + s - 1`` see among ``sk`` keys at ``0 .. sk - 1`` (a query
    offset: q-seq sharding's block of rows)."""
    pairs = 0
    for i in range(q0, q0 + s):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def flash_attention(b: int, s: int, hq: int, hkv: int, d: int, elem: int,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    sk: Optional[int] = None) -> Cost:
    """One flash forward of batch ``b``: q, k, v read once and the output
    written once (``elem`` bytes an element); the QK and PV products of
    the visible pairs, 4 D flops a pair and q head. ``q_offset`` / ``sk``:
    ``s`` query rows at positions ``q_offset ..`` against ``sk`` keys."""
    if sk is None and not q_offset:
        nbytes = b * (2 * hq + 2 * hkv) * s * d * elem
        return b * 4 * d * hq * visible_pairs(s, causal, window), nbytes
    sk = s if sk is None else sk
    nbytes = b * (2 * hq * s + 2 * hkv * sk) * d * elem
    pairs = visible_pairs_rows(q_offset, s, sk, causal, window)
    return b * 4 * d * hq * pairs, nbytes


def flash_attention_backward(b: int, s: int, hq: int, hkv: int, d: int,
                             elem: int = 4, causal: bool = True,
                             window: int = 0) -> Cost:
    """One flash backward: q, k, v, o, do read once and dq, dk, dv written
    once, all at ``elem`` bytes (the kernel takes and writes the inputs'
    dtype), and the forward's f32 row log-sum-exp [B Hq, S] read once; the
    five products of the visible pairs (scores, do.v, P^T do, dS^T q,
    dS k: 10 D flops a pair and q head)."""
    nbytes = elem * b * s * d * (4 * hq + 4 * hkv) + 4 * b * hq * s
    flops = 10 * d * hq * b * visible_pairs(s, causal, window)
    return flops, nbytes


def paged_attention(hq: int, hkv: int, d: int, bs: int, elem: int, c: int,
                    window: int, tables: Sequence[Sequence[int]],
                    start: Sequence[int], pos_base=None,
                    lse: bool = False) -> Cost:
    """One paged decode (``c`` 1) or prefill call over ``tables`` [B, MB]
    (block ids, -1 unassigned) with row b's queries at ``start[b] + i``:
    q read and the output written once, the tables and positions read,
    and the K/V blocks some query sees read once; the QK and PV products
    of the visible (query, key) pairs, 4 D flops a pair and q head. The
    partial mode: ``bs`` keys a block of the pool slice at in-block
    offsets ``off ..`` of ``BS_g`` (``pos_base = (BS_g, off)``), only the
    slice's keys read; ``lse``: each row's log-sum-exp written (f32)."""
    bs_g, off = pos_base if pos_base is not None else (bs, 0)
    nb = len(tables)
    nbytes = 2 * nb * c * hq * d * elem + nb * len(tables[0]) * 4 + nb * 4
    if lse:
        nbytes += 4 * nb * c * hq
    pairs = 0
    for b in range(nb):
        s0 = int(start[b])
        for j, blk in enumerate(tables[b]):
            k0 = j * bs_g + off
            if blk < 0 or k0 > s0 + c - 1:
                continue
            if window and k0 + bs - 1 <= s0 - window:
                continue
            nbytes += 2 * bs * hkv * d * elem
            for qi in range(c):
                qpos = s0 + qi
                lo = qpos - window + 1 if window else 0
                pairs += max(0, min(qpos, k0 + bs - 1) - max(lo, k0) + 1)
    return 4 * d * hq * pairs, nbytes


def full_table(b: int, mb: int, bs: int, c: int):
    """(tables, start) of ``b`` rows whose ``mb`` table columns are all
    assigned, the queries at the table's last ``c`` positions: the most a
    paged call of that shape can cost."""
    return ([list(range(r * mb, (r + 1) * mb)) for r in range(b)],
            [mb * bs - c] * b)


# ---------------------------------------------------------------------------
# grouped matmul and the SSD scan
# ---------------------------------------------------------------------------
def grouped_matmul(g: int, c: int, k: int, n: int, elem: int,
                   rows: Optional[Sequence[int]] = None) -> Cost:
    """One grouped matmul [G, C, K] x [G, K, N]: the valid x rows and the
    weights of the groups that have a valid row read once, ``valid_rows``
    read and the whole output written once; 2 K N flops a valid row.
    ``rows``: each group's valid rows (None: all C, and no valid_rows)."""
    valid = [c] * g if rows is None else [min(max(int(r), 0), c)
                                          for r in rows]
    nbytes = (sum(valid) * k * elem + sum(r > 0 for r in valid) * k * n * elem
              + g * c * n * elem + (0 if rows is None else 4 * g))
    return 2 * k * n * sum(valid), nbytes


def ssd_scan(b: int, s: int, h: int, p: int, n: int, q: int) -> Cost:
    """One SSD scan (f32): x, a, B and C read once and y written once; the
    visible work per (row, chunk): causal scores (2 N a pair j <= i),
    scores times x (2 P a pair), the inter-chunk term and the state update
    (2 Q N P each)."""
    nbytes = 4 * b * s * h * (2 * p + 2 * n + 1)
    pairs = q * (q + 1) // 2
    flops = b * h * (s // q) * (2 * pairs * (n + p) + 4 * q * n * p)
    return flops, nbytes


def ssd_scan_backward(b: int, s: int, h: int, p: int, n: int, q: int) -> Cost:
    """One SSD backward (f32): x, a, B, C and dy read once, the forward's
    chunk states read once, and dx, da, dB and dC written once; C.B^T,
    dy.x^T, dx, dB and dC over each chunk's causal pairs (2 (3N + 2P)
    flops a pair), and the reversed state and the three inter terms (8 Q N
    P a chunk), a (row, chunk) each."""
    chunks = b * h * (s // q)
    nbytes = 4 * (b * s * h * (3 * p + 4 * n + 2) + chunks * n * p)
    pairs = q * (q + 1) // 2
    flops = chunks * (2 * pairs * (3 * n + 2 * p) + 8 * q * n * p)
    return flops, nbytes


def bound_ms(flops: int, nbytes: int, *, f32: bool = True,
             mma: bool = True) -> Tuple[float, float]:
    """(bytes ms, ops ms): ``nbytes`` over HBM bandwidth, and ``flops`` at
    the rate of the units that run them: the f32 peak outside the tensor
    cores, or (``mma``) the tensor cores as the kernels use them, three
    TF32 passes for f32 and one bf16 pass otherwise."""
    if not mma:
        ops = 1e3 * flops / F32_FLOPS
    elif f32:
        ops = 1e3 * 3 * flops / TF32_FLOPS
    else:
        ops = 1e3 * flops / PEAK_FLOPS_BF16
    return 1e3 * nbytes / HBM_BW, ops
