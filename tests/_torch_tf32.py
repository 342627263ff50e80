"""The tensor-core kernels' f32 arithmetic on the CPU, for the port's tests.

The hand-written CUDA kernels run each f32 product on mma.sync TF32 in
three passes (``kernels/csrc/mma.cuh``); these helpers compute the same
products in PyTorch so a CPU test can hold the arithmetic, one pass or
three, against the JAX package.
"""
import torch


def tf32(x):
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds."""
    u = x.contiguous().view(torch.int32)
    mag = ((u & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | (u & -0x80000000)).view(torch.float32)


def tf32_trunc(x):
    """float32 truncated to TF32: what the tensor cores read of an operand
    whose 13 low bits are not clear."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x, lo_trunc=False):
    """(hi, lo) of x = hi + lo: hi = tf32(x); lo = tf32(x - hi), or, as the
    grouped-matmul and SSD kernels hand it over (``tc::split_int``), x - hi
    truncated by the tensor cores."""
    hi = tf32(x)
    return hi, (tf32_trunc if lo_trunc else tf32)(x - hi)


def mm(a, b, passes, lo_trunc=False):
    """a @ b as mma.sync computes it: one TF32 pass or three (lo.hi +
    hi.lo + hi.hi of each operand's ``split``), each product summed in
    f32."""
    (ah, al), (bh, bl) = split(a, lo_trunc), split(b, lo_trunc)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh
