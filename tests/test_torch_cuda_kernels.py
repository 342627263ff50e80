"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. The file imports neither JAX nor the JAX package, so it
runs on a machine that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances are tests/test_kernels.py's: 2e-5 in f32, 2e-2 in bf16 (the
grouped matmul's inputs are scaled so its outputs are of order one), 5e-4
for the SSD scan (its f32 sums run over up to a 256-long chunk and the
state, in other orders than the plain version's einsums).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ssd

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(device, dtype, b, c, seed):
    """qwen2-0.5b's serve shapes: 14 q heads over 2 kv heads, head_dim 64,
    block 16, 64 table columns, scattered blocks, a last all -1 row."""
    g = torch.Generator(device=device).manual_seed(seed)
    nb, bs, hkv, hq, d, mb = 160, 16, 2, 14, 64, 64
    kp = torch.randn(nb, bs, hkv, d, generator=g, device=device).to(dtype)
    vp = torch.randn(nb, bs, hkv, d, generator=g, device=device).to(dtype)
    perm = torch.randperm(nb, generator=g, device=device).to(torch.int32)
    start = torch.randint(1, 300, (b,), generator=g, device=device,
                          dtype=torch.int32)
    tables = torch.full((b, mb), -1, dtype=torch.int32, device=device)
    for i in range(b - 1):
        n = (int(start[i]) + c - 1) // bs + 1
        tables[i, :n] = perm[i * 20:i * 20 + n]
    q = torch.randn(b, c, hq, d, generator=g, device=device).to(dtype)
    return q, kp, vp, tables, start


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_kernel_matches_plain(cuda_device, dtype, window):
    q, kp, vp, tables, pos = _case(cuda_device, dtype, 8, 1, 1 + window)
    before = ops.paged_attention.launches
    out = ops.paged_attention(q[:, 0], kp, vp, tables, pos, window)
    exp = pa.paged_attention_plain(q[:, 0], kp, vp, tables, pos, window)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q[:, 0].shape
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert (out[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5])
def test_prefill_kernel_matches_plain(cuda_device, dtype, window):
    q, kp, vp, tables, start = _case(cuda_device, dtype, 4, 16, 2 + window)
    before = ops.paged_prefill_attention.launches
    out = ops.paged_prefill_attention(q, kp, vp, tables, start, window)
    exp = pa.paged_prefill_attention_plain(q, kp, vp, tables, start, window)
    torch.cuda.synchronize()
    assert ops.paged_prefill_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert (out[-1] == 0).all()


@pytest.mark.cuda
def test_kernels_raise_on_what_they_do_not_take(cuda_device):
    """No fallback: an input the kernels do not take raises."""
    q, kp, vp, tables, pos = _case(cuda_device, torch.float32, 2, 16, 0)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_attention(q[:, 0], kp, vp, tables.long(), pos)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_prefill_attention(strided, kp, vp, tables, pos)
    with pytest.raises(ValueError, match="dtype"):
        ops.paged_attention(q[:, 0].double(), kp, vp, tables, pos)


def _flash_case(device, dtype, s, hq, hkv, d, seed, b=1):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, s, hq, d, generator=g, device=device).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g, device=device).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g, device=device).to(dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", [
    (1, 256, 16, 16, 128, True, 0),   # olmoe-1b-7b's prefill
    (1, 128, 14, 2, 64, True, 5),     # G = 7, sliding window
    (1, 128, 8, 2, 64, False, 0),     # non-causal
    (1, 200, 4, 4, 128, True, 0),     # ragged causal S
    (1, 1, 4, 4, 64, True, 0),        # one row, one key
    (2, 15, 14, 2, 32, True, 0),      # a tile that is mostly padding
    (1, 64, 8, 1, 128, True, 0),      # G = 8
    (1, 512, 7, 1, 64, True, 0),      # G = 7, eight key tiles
    (1, 200, 8, 1, 128, True, 5),     # ragged S with a window
    (2, 64, 4, 4, 32, False, 0),      # non-causal, D 32
    (1, 512, 2, 2, 128, False, 0),    # non-causal, eight key tiles
    (1, 1024, 32, 32, 96, True, 0),   # phi-3-vision's prefill, D 96
    (1, 200, 32, 32, 96, True, 5),    # D 96, ragged S with a window
    (1, 128, 8, 2, 96, False, 0),     # D 96, non-causal, G = 4
    (1, 448, 20, 20, 64, True, 0),    # whisper-large-v3's decoder: G 1,
                                      # a partial last row tile
])
def test_flash_kernel_matches_plain(cuda_device, dtype, b, s, hq, hkv, d,
                                    causal, window):
    q, k, v = _flash_case(cuda_device, dtype, s, hq, hkv, d, s + hq + d, b)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    exp = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    q, k, v = _flash_case(cuda_device, torch.float32, 64, 8, 2, 64, 3)
    fused = torch.cat([q, k, v], dim=2)
    qv, kv, vv = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    torch.testing.assert_close(ops.flash_attention(qv, kv, vv),
                               fa.flash_attention_plain(q, k, v),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_unaligned_views(cuda_device, dtype):
    """Rows that are not 16-byte aligned (head_dim + 1 floats apart, one
    element in) take the kernel's plain-load path: same result."""
    q, k, v = _flash_case(cuda_device, dtype, 100, 4, 2, 64, 4)
    views = []
    for t in (q, k, v):
        wide = torch.zeros(*t.shape[:3], 65, dtype=dtype, device=cuda_device)
        wide[..., 1:] = t
        views.append(wide[..., 1:])
    assert views[1].stride(1) % 4
    torch.testing.assert_close(
        ops.flash_attention(*views).float(),
        fa.flash_attention_plain(q, k, v).float(), atol=TOL[dtype],
        rtol=TOL[dtype])


def _paged_sweep_case(device, dtype, c, hq, hkv, bs, mb, d, seed):
    """Three rows: row 0 with a -1 hole mid-table (a column its chunk could
    see), row 1 full, row 2 all -1. q is scaled by 2 so each row's
    probabilities vary strongly across keys: a P fragment in the wrong
    column order moves the output far past the tolerance."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, nb = 3, 2 * mb + 4
    kp = torch.randn(nb, bs, hkv, d, generator=g, device=device).to(dtype)
    vp = torch.randn(nb, bs, hkv, d, generator=g, device=device).to(dtype)
    perm = torch.randperm(nb, generator=g, device=device).to(torch.int32)
    hi = mb * bs - c
    start = torch.randint(0, hi + 1, (b,), generator=g, device=device,
                          dtype=torch.int32)
    start[0] = hi                        # the last column in use
    tables = torch.full((b, mb), -1, dtype=torch.int32, device=device)
    for i in range(b - 1):
        n = (int(start[i]) + c - 1) // bs + 1
        tables[i, :n] = perm[i * mb:i * mb + n]
    if mb > 2:
        tables[0, mb // 2] = -1
    q = (2 * torch.randn(b, c, hq, d, generator=g, device=device)).to(dtype)
    return q, kp, vp, tables, start


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5, 40])
@pytest.mark.parametrize("c,hq,hkv,bs,mb,d", [
    (16, 14, 2, 16, 64, 64),     # qwen2-0.5b's engine shape
    (1, 14, 2, 16, 64, 64),      # C = 1
    (7, 7, 1, 8, 65, 64),        # C = 7, G = 7, block 8, MB = 65
    (32, 4, 4, 32, 64, 128),     # C = 32, G = 1, block 32
    (16, 2, 2, 16, 1, 32),       # MB = 1: one split, direct output
    (32, 14, 2, 8, 65, 64),      # 224 rows: two row groups
    (16, 8, 1, 16, 64, 128),     # G = 8 at D 128
    (16, 32, 32, 16, 32, 96),    # phi-3-vision's engine shape: G = 1, D 96
    (16, 16, 16, 16, 16, 128),   # olmoe-1b-7b's engine shape: G = 1, D 128
    (7, 14, 2, 8, 65, 96),       # D 96, C = 7, G = 7, MB = 65
])
def test_prefill_kernel_sweep(cuda_device, dtype, window, c, hq, hkv, bs,
                              mb, d):
    q, kp, vp, tables, start = _paged_sweep_case(
        cuda_device, dtype, c, hq, hkv, bs, mb, d, c * 7 + bs + mb + window)
    before = ops.paged_prefill_attention.launches
    out = ops.paged_prefill_attention(q, kp, vp, tables, start, window)
    exp = pa.paged_prefill_attention_plain(q, kp, vp, tables, start, window)
    torch.cuda.synchronize()
    assert ops.paged_prefill_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert (out[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 2, 4, 64])
def test_prefill_split_widths_agree(cuda_device, monkeypatch, cols):
    """Every width of the split table walk gives the plain result (1 column
    a split up to the whole table, which writes the output directly)."""
    q, kp, vp, tables, start = _paged_sweep_case(
        cuda_device, torch.float32, 16, 14, 2, 16, 64, 64, cols)
    monkeypatch.setattr(pa, "SPLIT_KEYS", cols * kp.shape[1])
    out = pa.paged_prefill_cuda(q, kp, vp, tables, start, 0)
    exp = pa.paged_prefill_attention_plain(q, kp, vp, tables, start, 0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, exp, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5, 40])
@pytest.mark.parametrize("hq,hkv,bs,mb,d", [
    (14, 2, 16, 64, 64),         # qwen2-0.5b's engine shape, G = 7
    (4, 4, 8, 65, 32),           # G = 1, block 8, MB = 65
    (32, 2, 32, 65, 128),        # G = 16: one full m16 tile, block 32
    (32, 1, 16, 65, 64),         # G = 32: two row tiles
    (64, 2, 8, 64, 128),         # G = 32 at D 128
    (7, 1, 8, 1, 64),            # MB = 1: one split, direct output
    (16, 1, 32, 1, 32),          # MB = 1, G = 16, D 32, block 32
    (32, 32, 16, 32, 96),        # phi-3-vision's engine shape: G = 1, D 96
    (16, 16, 16, 16, 128),       # olmoe-1b-7b's engine shape: G = 1, D 128
    (64, 2, 8, 65, 96),          # G = 32 at D 96: two row tiles
])
def test_decode_kernel_sweep(cuda_device, dtype, window, hq, hkv, bs, mb, d):
    """The decode kernel over head dims, block sizes, q-head groups (one
    and two m16 row tiles) and table widths: row 0 at the last position
    its table holds with a -1 hole mid-table, row 1 at a random one, row
    2 all -1 (exactly zero)."""
    q, kp, vp, tables, pos = _paged_sweep_case(
        cuda_device, dtype, 1, hq, hkv, bs, mb, d, hq + bs + mb + window)
    q = q[:, 0]
    before = ops.paged_attention.launches
    out = ops.paged_attention(q, kp, vp, tables, pos, window)
    exp = pa.paged_attention_plain(q, kp, vp, tables, pos, window)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert (out[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 2, 4, 64])
def test_decode_split_widths_agree(cuda_device, monkeypatch, cols):
    """Every width of the decode's split table walk gives the plain result
    (1 column a split up to the whole table, which writes the output
    directly)."""
    q, kp, vp, tables, pos = _paged_sweep_case(
        cuda_device, torch.float32, 1, 14, 2, 16, 64, 64, cols)
    monkeypatch.setattr(pa, "DECODE_SPLIT_KEYS", cols * kp.shape[1])
    out = pa.paged_attention_cuda(q[:, 0], kp, vp, tables, pos, 0)
    exp = pa.paged_attention_plain(q[:, 0], kp, vp, tables, pos, 0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, exp, atol=2e-5, rtol=2e-5)
    assert (out[-1] == 0).all()


@pytest.mark.cuda
def test_decode_kernel_replays_in_a_cuda_graph(cuda_device):
    """A decode call captured in a CUDA graph replays right after its
    positions, table and q change on the device: the wrapper reads nothing
    to the host and the kernels keep no state between calls."""
    q, kp, vp, tables, pos = _paged_sweep_case(
        cuda_device, torch.float32, 1, 14, 2, 16, 64, 64, 11)
    q = q[:, 0].clone()
    ops.paged_attention(q, kp, vp, tables, pos)          # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.paged_attention(q, kp, vp, tables, pos)
    for step in range(3):
        pos[1:] = (pos[1:] + 37 * step) % (tables.shape[1] * kp.shape[1])
        tables[1] = torch.roll(tables[1], step)
        q.mul_(-1.0)
        graph.replay()
        exp = pa.paged_attention_plain(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, exp, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", ["none", "random", "some_empty"])
def test_grouped_matmul_kernel_matches_plain(cuda_device, dtype, valid):
    """olmoe-1b-7b's down projection shape at a 256-token capacity (40
    rows), narrowed to 8 experts."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(8, 40, 1024, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(8, 1024, 2048, generator=g, device=cuda_device)
         / 32.0).to(dtype)
    rows = None
    if valid != "none":
        rows = torch.randint(0, 41, (8,), generator=g, device=cuda_device,
                             dtype=torch.int32)
        if valid == "some_empty":
            rows[::2] = 0
    before = ops.grouped_matmul.launches
    out = ops.grouped_matmul(x, w, rows)
    exp = gmm.grouped_matmul_plain(x, w, rows)
    torch.cuda.synchronize()
    assert ops.grouped_matmul.launches == before + 1
    assert out.dtype == dtype and out.shape == (8, 40, 2048)
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if rows is not None:
        mask = torch.arange(40, device=cuda_device)[None, :] >= rows[:, None]
        assert (out[mask] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,k,n,valid", [
    (1, 256, 256, "none"),        # one row: one m16 tile, 15 rows masked
    (8, 512, 384, "random"),      # olmoe-1b-7b's decode capacity
    (40, 2048, 256, "random"),    # its prefill capacity: three m16 tiles
    (65, 512, 256, "random"),     # two row tiles, the second of one row
    (128, 256, 320, "none"),      # two full row tiles, a ragged N tile
    (40, 100, 72, "random"),      # ragged K and N on 16-byte rows (f32)
    (40, 37, 50, "random"),       # rows not 16-byte aligned: plain loads
    (40, 512, 256, "empty"),      # every expert empty
])
def test_grouped_matmul_kernel_shapes(cuda_device, dtype, c, k, n, valid):
    g = torch.Generator(device=cuda_device).manual_seed(c + k + n)
    x = torch.randn(4, c, k, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(4, k, n, generator=g, device=cuda_device)
         / k ** 0.5).to(dtype)
    rows = None
    if valid == "random":
        rows = torch.randint(0, c + 1, (4,), generator=g, device=cuda_device,
                             dtype=torch.int32)
    elif valid == "empty":
        rows = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    out = ops.grouped_matmul(x, w, rows)
    exp = gmm.grouped_matmul_plain(x, w, rows)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (4, c, n)
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if rows is not None:
        mask = torch.arange(c, device=cuda_device)[None, :] >= rows[:, None]
        assert (out[mask] == 0).all()


@pytest.mark.cuda
def test_new_kernels_raise_on_what_they_do_not_take(cuda_device):
    q, k, v = _flash_case(cuda_device, torch.float32, 16, 4, 2, 48, 0)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, k, v)
    q, k, v = _flash_case(cuda_device, torch.float32, 16, 4, 2, 64, 0)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, k.double(), v)
    x = torch.zeros(2, 8, 16, device=cuda_device)
    w = torch.zeros(2, 16, 4, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        ops.grouped_matmul(x, w, torch.zeros(2, dtype=torch.int64,
                                             device=cuda_device))
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ops.grouped_matmul(strided, w)


def _ssd_case(device, b, s, h, p, n, seed):
    """The JAX kernel test's inputs (``tests/test_kernels.py:126-130``):
    decays -softplus(normal), B and C at half scale."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, device=device)
    a = -torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=g, device=device))
    B = torch.randn(b, s, h, n, generator=g, device=device) * 0.5
    C = torch.randn(b, s, h, n, generator=g, device=device) * 0.5
    return x, a, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 512, 4, 64, 128, 256),       # mamba2-780m's widths, 2 chunks
    (2, 64, 16, 32, 16, 32),         # the smoke widths
    (2, 96, 3, 64, 64, 32),          # ragged row tiles, 3 chunks
    (1, 64, 1, 32, 16, 128),         # chunk halves to S
    (1, 40, 2, 48, 8, 8),            # P not a multiple of 32
    (1, 512, 112, 64, 64, 256),      # zamba2-7b's widths: 112 heads, N 64
    (1, 4096, 112, 64, 64, 256),     # zamba2-7b's forward shape
])
def test_ssd_scan_kernel_matches_plain(cuda_device, b, s, h, p, n, chunk):
    x, a, B, C = _ssd_case(cuda_device, b, s, h, p, n, s + n)
    before = ops.ssd_scan.launches
    out = ops.ssd_scan(x, a, B, C, chunk=chunk)
    q = chunk
    while s % q:
        q //= 2
    exp = ssd.ssd_scan_plain(x, a, B, C, chunk=q)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == x.shape
    torch.testing.assert_close(out, exp, atol=5e-4, rtol=5e-4)


@pytest.mark.cuda
def test_ssd_scan_kernel_refuses_grad_and_bad_inputs(cuda_device):
    """An input that requires grad now gets its gradient from the backward
    kernel (held to autograd of the plain version), and anything the
    kernel does not take raises: there is no fallback."""
    x, a, B, C = _ssd_case(cuda_device, 1, 64, 2, 32, 16, 0)
    before = ops.ssd_scan.launches, ops.ssd_scan_backward.launches
    xg = x.clone().requires_grad_()
    dy = torch.randn_like(x)
    ops.ssd_scan(xg, a, B, C, chunk=32).backward(dy)
    assert (ops.ssd_scan.launches, ops.ssd_scan_backward.launches) == (
        before[0] + 1, before[1] + 1)
    want = ssd.ssd_scan_backward_plain(x, a, B, C, dy, chunk=32)[0]
    _close_to_largest(xg.grad, want, SSD_BWD_TOL)
    with torch.no_grad():
        ops.ssd_scan(x.requires_grad_(), a, B, C, chunk=32)
    assert ops.ssd_scan.launches == before[0] + 2
    x = x.detach()
    with pytest.raises(ValueError, match="float32"):
        ssd.ssd_scan_cuda(x.double(), a, B, C, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                          a, B, C, chunk=32)
    with pytest.raises(ValueError, match="divide"):
        ssd.ssd_scan_cuda(x, a, B, C, chunk=48)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 64, 2, 1024, device=cuda_device)
        ssd.ssd_scan_cuda(x, a, big, big, chunk=64)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 256, 3, 64, 128, 256),       # one chunk: no state, no pass
    (2, 512, 2, 64, 128, 256),       # two chunks
    (1, 17 * 64, 2, 64, 128, 64),    # 17 chunks of one tile each
    (2, 17 * 32, 4, 32, 16, 32),     # 17 chunks at P 32 / N 16
])
def test_ssd_scan_kernel_chunk_counts(cuda_device, b, s, h, p, n, chunk):
    x, a, B, C = _ssd_case(cuda_device, b, s, h, p, n, s + p)
    out = ops.ssd_scan(x, a, B, C, chunk=chunk)
    exp = ssd.ssd_scan_plain(x, a, B, C, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, exp, atol=5e-4, rtol=5e-4)


@pytest.mark.cuda
def test_redesigned_kernels_raise_on_shapes_they_do_not_take(cuda_device):
    """The SSD kernels hold all of P in a warp (P a multiple of 8, at most
    64) and step N by 8; the grouped matmul takes one dtype for x and w."""
    for p, n in ((12, 16), (128, 16), (32, 12)):
        x, a, B, C = _ssd_case(cuda_device, 1, 64, 2, p, n, 0)
        with pytest.raises(ValueError, match="multiple of 8"):
            ssd.ssd_scan_cuda(x, a, B, C, chunk=32)
    x = torch.zeros(2, 8, 16, device=cuda_device)
    w = torch.zeros(2, 16, 4, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        ops.grouped_matmul(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="need x"):
        ops.grouped_matmul(x, w[:, :8])


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ssd_scan", "grouped_matmul"])
def test_kernels_launch_on_the_current_stream(cuda_device, op):
    """On a side stream whose input is written only after a long device
    spin, every kernel must run behind that write: a launch on any other
    stream would read the zeros the input held before."""
    if op == "ssd_scan":
        args = list(_ssd_case(cuda_device, 2, 1024, 4, 64, 128, 5))
        fn = lambda *t: ops.ssd_scan(*t, chunk=256)          # noqa: E731
        plain = lambda *t: ssd.ssd_scan_plain(*t, chunk=256)  # noqa: E731
    else:
        g = torch.Generator(device=cuda_device).manual_seed(5)
        args = [torch.randn(8, 40, 1024, generator=g, device=cuda_device),
                torch.randn(8, 1024, 512, generator=g, device=cuda_device)
                / 32.0]
        fn, plain = ops.grouped_matmul, gmm.grouped_matmul_plain
    exp = plain(*args)
    late = torch.zeros_like(args[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        late.copy_(args[0])
        out = fn(late, *args[1:])
    side.synchronize()
    tol = 5e-4 if op == "ssd_scan" else TOL[torch.float32]
    torch.testing.assert_close(out, exp, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# backward kernels: each autograd Function against autograd of the plain
# version. Tolerances are relative to the largest gradient: 2e-5 for flash
# in f32 (three TF32 passes on the tensor cores against the plain version's
# f32 einsums) and 2e-2 in bf16 (one bf16 pass, P and dS rounded to bf16,
# against the plain version on the same inputs upcast to f32), 5e-4 for
# the SSD scan (the forward's 5e-4: sums of up to a chunk's 256 terms and
# the chunk states' recurrence, in other orders)
# ---------------------------------------------------------------------------
FLASH_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_BWD_TOL = 5e-4


def _close_to_largest(got, want, tol):
    assert got is not None and got.shape == want.shape
    torch.cuda.synchronize()
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", [
    (1, 256, 16, 16, 128, True, 0),   # olmoe-1b-7b
    (2, 1024, 32, 32, 96, True, 0),   # phi-3-vision-4.2b, the train step
    (1, 448, 20, 20, 64, True, 0),    # whisper-large-v3's decoder
    (1, 200, 14, 2, 64, True, 5),     # GQA, window, ragged S
    (1, 128, 14, 2, 64, False, 0),    # non-causal
    (1, 70, 2, 1, 32, True, 0),
    (1, 300, 16, 4, 128, True, 40),   # D 128, GQA 16/4, window, ragged S
])
def test_flash_attention_gradients_match_plain(cuda_device, b, s, hq, hkv, d,
                                               causal, window, dtype):
    """Backward through ops.flash_attention on the card gives q, k and v
    gradients in the inputs' dtype, equal to autograd of the plain version
    on the same inputs (upcast to f32 for bf16)."""
    q, k, v = _flash_case(cuda_device, dtype, s, hq, hkv, d, s + d, b=b)
    do = torch.randn(q.shape, device=cuda_device).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (ops.flash_attention.launches,
              ops.flash_attention_backward.launches,
              fa.flash_attention_plain.calls)
    ops.flash_attention(*leaves, causal=causal, window=window).backward(do)
    assert (ops.flash_attention.launches,
            ops.flash_attention_backward.launches,
            fa.flash_attention_plain.calls) == (before[0] + 1, before[1] + 1,
                                                before[2])
    want = fa.flash_attention_backward_plain(
        *(t.float() for t in (q, k, v, do)), causal, window)
    for t, w in zip(leaves, want):
        assert t.grad.dtype == dtype
        _close_to_largest(t.grad.float(), w, FLASH_BWD_TOL[dtype])


@pytest.mark.cuda
def test_flash_backward_refuses_float16(cuda_device):
    """f32 and bf16 launch; float16 raises on the card (no fallback), in
    the forward with its log-sum-exp and in the backward."""
    q, k, v = _flash_case(cuda_device, torch.float16, 64, 2, 2, 64, 0)
    lse = torch.zeros(2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_backward_cuda(q, k, v, q, q, lse)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_cuda(q, k, v, return_lse=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(*leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,window", [
    (2, 1024, 32, 32, 96, 0),         # phi-3-vision-4.2b's train step
    (1, 200, 14, 2, 64, 5),           # GQA, window, ragged S
    (1, 70, 2, 1, 32, 0),
])
def test_flash_forward_lse_matches_plain(cuda_device, b, s, hq, hkv, d,
                                         window, dtype):
    """The training forward's row log-sum-exp, f32 for either input dtype:
    the plain version's logsumexp of the scaled visible scores on the same
    inputs (upcast to f32), and its output the plain output."""
    q, k, v = _flash_case(cuda_device, dtype, s, hq, hkv, d, s + hq, b=b)
    out, lse = fa.flash_attention_cuda(q, k, v, window=window,
                                       return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b * hq, s)
    qf, kf = q.float(), k.float().repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / d ** 0.5
    pos = torch.arange(s, device=cuda_device)
    vis = (pos[:, None] >= pos[None, :])
    if window:
        vis &= pos[:, None] - pos[None, :] < window
    want = torch.logsumexp(logits.masked_fill(~vis, float("-inf")), -1)
    torch.testing.assert_close(lse, want.reshape(b * hq, s), atol=1e-4,
                               rtol=1e-5)
    exp = fa.flash_attention_plain(q, k, v, True, window)
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,window", [
    (1, 448, 20, 20, 64, 0),          # whisper-large-v3: the rule takes 2 x 4
    (2, 1024, 32, 32, 96, 0),         # phi-3-vision-4.2b's train step: 4 x 2
    (1, 200, 14, 2, 32, 5),           # GQA, window, ragged S
    (1, 300, 16, 4, 128, 40),         # D 128: 2 x 4 only
])
def test_flash_backward_cta_shapes_agree(cuda_device, b, s, hq, hkv, d,
                                         window, dtype):
    """Each CTA shape, forced, against the plain backward; the 4 x 2 shape
    is refused where its fragments do not fit (D > 96)."""
    q, k, v = _flash_case(cuda_device, dtype, s, hq, hkv, d, s + d, b=b)
    do = torch.randn(q.shape, device=cuda_device).to(dtype)
    o, lse = fa.flash_attention_cuda(q, k, v, window=window, return_lse=True)
    want = fa.flash_attention_backward_plain(
        *(t.float() for t in (q, k, v, do)), True, window)
    for groups in (4, 2):
        if groups == 4 and d > 96:
            with pytest.raises(ValueError, match="groups"):
                fa.flash_attention_backward_cuda(q, k, v, o, do, lse,
                                                 window=window, groups=4)
            continue
        got = fa.flash_attention_backward_cuda(q, k, v, o, do, lse,
                                               window=window, groups=groups)
        for t, w in zip(got, want):
            assert t.dtype == dtype
            _close_to_largest(t.float(), w, FLASH_BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 4096, 48, 64, 128, 256),      # mamba2-780m's train step
    (1, 4096, 112, 64, 64, 256),      # zamba2-7b
    (2, 256, 4, 32, 16, 32),          # smoke widths
    (1, 96, 3, 64, 96, 64),           # chunk halves to 32; N 96
])
def test_ssd_scan_gradients_match_plain(cuda_device, b, s, h, p, n, chunk):
    x, a, B, C = _ssd_case(cuda_device, b, s, h, p, n, s + n)
    dy = torch.randn_like(x)
    leaves = [t.clone().requires_grad_() for t in (x, a, B, C)]
    before = ops.ssd_scan_backward.launches, ssd.ssd_scan_plain.calls
    ops.ssd_scan(*leaves, chunk=chunk).backward(dy)
    assert (ops.ssd_scan_backward.launches, ssd.ssd_scan_plain.calls) == (
        before[0] + 1, before[1])
    q = chunk
    while s % q:
        q //= 2
    want = ssd.ssd_scan_backward_plain(x, a, B, C, dy, chunk=q)
    for t, w in zip(leaves, want):
        _close_to_largest(t.grad, w, SSD_BWD_TOL)


@pytest.mark.cuda
def test_routes_without_a_backward_raise_under_grad(cuda_device):
    """The paged kernels and the grouped matmul have no backward: with an
    input that requires grad under grad mode they raise instead of
    returning a result without a gradient; under no_grad they launch."""
    q, kp, vp, tables, start = _case(cuda_device, torch.float32, 4, 3, 0)
    qg = q.clone().requires_grad_()
    q1 = q[:, 0].contiguous().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.paged_attention(q1, kp, vp, tables, start)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.paged_prefill_attention(qg, kp, vp, tables, start)
    x = torch.randn(2, 8, 64, device=cuda_device)
    w = torch.randn(2, 64, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.grouped_matmul(x, w)
    with torch.no_grad():
        ops.paged_attention(q1, kp, vp, tables, start)
        ops.paged_prefill_attention(qg, kp, vp, tables, start)
        ops.grouped_matmul(x, w)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# sharded serving: one rank's local heads, two gloo ranks on one card
# ---------------------------------------------------------------------------
def _rank_case(device, dtype, b, c, seed, hq=7, hkv=1):
    """One rank's share of qwen2-0.5b over a 'model' axis of 2: 7 q heads
    over 1 kv head (G 7), head_dim 64, block 16, 64 table columns,
    positions up to ~1000, a last all -1 row."""
    g = torch.Generator(device=device).manual_seed(seed)
    nb, bs, d, mb = 512, 16, 64, 64
    kp = torch.randn(nb, bs, hkv, d, generator=g, device=device).to(dtype)
    vp = torch.randn(nb, bs, hkv, d, generator=g, device=device).to(dtype)
    perm = torch.randperm(nb, generator=g, device=device).to(torch.int32)
    start = torch.randint(1, mb * bs - c, (b,), generator=g, device=device,
                          dtype=torch.int32)
    tables = torch.full((b, mb), -1, dtype=torch.int32, device=device)
    for i in range(b - 1):
        n = (int(start[i]) + c - 1) // bs + 1
        tables[i, :n] = perm[i * mb:i * mb + n]
    q = torch.randn(b, c, hq, d, generator=g, device=device).to(dtype)
    return q, kp, vp, tables, start


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5])
def test_paged_kernels_at_a_ranks_local_heads(cuda_device, dtype, window):
    q, kp, vp, tables, pos = _rank_case(cuda_device, dtype, 8, 1, 7 + window)
    out = ops.paged_attention(q[:, 0], kp, vp, tables, pos, window)
    exp = pa.paged_attention_plain(q[:, 0], kp, vp, tables, pos, window)
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert (out[-1] == 0).all()
    q, kp, vp, tables, start = _rank_case(cuda_device, dtype, 4, 16,
                                          8 + window)
    out = ops.paged_prefill_attention(q, kp, vp, tables, start, window)
    exp = pa.paged_prefill_attention_plain(q, kp, vp, tables, start, window)
    torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert (out[-1] == 0).all()


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    """qwen2-0.5b smoke served by two gloo ranks on cuda:0 (mesh (1, 2):
    2 q heads and 1 kv head a rank) gives a single-process eager run's
    tokens, each rank launching both paged kernels and no plain version;
    a gloo collective inside a graph capture raises."""
    import os
    import pickle
    import socket
    import subprocess
    import sys

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.convert import params_to_jax
    from repro_torch.serve import ServeEngine, ServeRequest, graphs

    cfg = get_config("qwen2-0.5b", smoke=True)
    params = build_model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, cfg.vocab_size, size=s).astype(np.int32), 6,
             a) for s, a in zip([5, 3, 8, 2, 6], [0.0, 0.0, 1.0, 2.0, 2.0])]
    engine = dict(cache="paged", n_slots=4, max_len=64, block_size=8)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    spec = dict(world=2, port=port, device="cuda",
                params={"qwen2": params_to_jax(params)},
                scenarios=[dict(name="paged", arch="qwen2-0.5b",
                                params="qwen2", mesh=(1, 2), engine=engine,
                                requests=reqs),
                           dict(name="capture", kind="capture",
                                arch="qwen2-0.5b", params="qwen2",
                                mesh=(1, 2))])
    with open(tmp_path / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "_torch_sharded_ranks.py"),
         str(tmp_path / "spec.pkl"), str(tmp_path)], env=env,
        capture_output=True, text=True, timeout=600)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
        assert "error" not in ranks[-1], ranks[-1].get("error")
    assert proc.returncode == 0, proc.stderr[-3000:]
    with graphs.eager():
        single, _ = ServeEngine(cfg, params=params, device=cuda_device,
                                **engine).run(
            [ServeRequest(p.copy(), max_new_tokens=m, arrival_time=a)
             for p, m, a in reqs])
    for res in ranks:
        run = res["paged"]
        assert run["tokens"] == [r.output for r in single]
        assert run["graphs"] == "eager"
        assert run["launches"]["paged_attention"] > 0
        assert run["launches"]["paged_prefill_attention"] > 0
        assert not any(n for k, n in run["launches"].items()
                       if k.endswith("_plain"))
        assert "cannot be captured" in res["capture"]["error"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_read_a_kv_head_slice_of_the_pool(cuda_device, dtype):
    """A KV-head slice of a pool (what a head-sharded rank reads when its
    KV heads are whole, ``layers.kv_heads_read``) is a strided view: both
    kernels read it in place and agree with the plain version; a pool
    whose strides break 16-byte rows raises."""
    q, kp, vp, tables, start = _case(cuda_device, dtype, 4, 16, 9)
    ks, vs = kp[:, :, 1:2], vp[:, :, 1:2]          # kv head 1 of 2
    assert not ks.is_contiguous()
    qh = q[:, :, 7:].contiguous()                  # its 7 q heads
    for out, exp in (
            (ops.paged_prefill_attention(qh, ks, vs, tables, start),
             pa.paged_prefill_attention_plain(qh, ks, vs, tables, start)),
            (ops.paged_attention(qh[:, 0].contiguous(), ks, vs, tables,
                                 start),
             pa.paged_attention_plain(qh[:, 0], ks, vs, tables, start))):
        torch.testing.assert_close(out.float(), exp.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
    wide = torch.zeros(*kp.shape[:2], 1, kp.shape[3] + 1, dtype=dtype,
                       device=cuda_device)[..., :kp.shape[3]]
    with pytest.raises(ValueError, match="16-byte"):
        ops.paged_attention(qh[:, 0].contiguous(), wide, wide, tables, start)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5])
def test_partial_mode_matches_plain_and_merges_to_the_whole(
        cuda_device, dtype, window):
    """The paged kernels' partial mode over 4 in-block slices of a
    16-position pool: each rank's output and row log-sum-exp against the
    plain version, and the merged slices against one whole-pool call."""
    from repro_torch.dist import sharding as shd
    for c in (1, 16):
        q, kp, vp, tables, start = _case(cuda_device, dtype,
                                         8 if c == 1 else 4, c, 20 + window)
        q = q[:, 0] if c == 1 else q
        wrapper = (ops.paged_attention_partial if c == 1
                   else ops.paged_prefill_partial)
        plain = (pa.paged_attention_plain if c == 1
                 else pa.paged_prefill_attention_plain)
        whole = ops.paged_attention if c == 1 else ops.paged_prefill_attention
        parts = []
        for r in range(4):
            ks, vs = (t[:, 4 * r:4 * r + 4].contiguous() for t in (kp, vp))
            o, lse = wrapper(q, ks, vs, tables, start, window, (16, 4 * r))
            eo, el = plain(q, ks, vs, tables, start, window, (16, 4 * r),
                           return_lse=True)
            torch.testing.assert_close(o.float(), eo.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])
            seen = torch.isfinite(el)
            assert torch.equal(torch.isfinite(lse), seen)
            torch.testing.assert_close(lse[seen], el[seen], atol=TOL[dtype],
                                       rtol=TOL[dtype])
            parts.append((o, lse))
        merged = shd.combine_partials(torch.stack([o for o, _ in parts]),
                                      torch.stack([l for _, l in parts]))
        torch.testing.assert_close(
            merged, whole(q, kp, vp, tables, start, window).float(),
            atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q0,sq,sk,window", [(192, 64, 256, 0),
                                             (0, 40, 40, 0),
                                             (100, 37, 200, 9)])
def test_flash_query_offset_matches_plain(cuda_device, dtype, q0, sq, sk,
                                          window):
    q, _, _ = _flash_case(cuda_device, dtype, sq, 14, 2, 64, q0 + 1)
    _, k, v = _flash_case(cuda_device, dtype, sk, 14, 2, 64, sk)
    before = ops.flash_attention_offset.launches
    out = ops.flash_attention_offset(q, k, v, q0, window=window)
    assert ops.flash_attention_offset.launches == before + 1
    torch.testing.assert_close(
        out.float(), fa.flash_attention_plain(q, k, v, True, window,
                                              q0).float(),
        atol=TOL[dtype], rtol=TOL[dtype])
    with pytest.raises(RuntimeError, match="no backward"):
        with torch.enable_grad():
            ops.flash_attention_offset(q.requires_grad_(), k, v, q0)
