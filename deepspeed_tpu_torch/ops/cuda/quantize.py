"""Grouped fake quantization: the CUDA kernel (csrc/quantize.cu) and its
plain PyTorch version.

Replaces ``deepspeed_tpu/ops/pallas/quantize.py:109`` ``quantize``
(``_quant_kernel`` :76): x of any shape, seen as [groups, n], quantized
to ``bits`` bits a group and dequantized back to x's dtype. The
arithmetic is the Pallas kernel's as XLA runs it: the division of the
group's amax (or range) by the constant qmax becomes a product with
fp32(1 / qmax), then x is divided by that scale (an IEEE division), so
``quantize_plain`` equals JAX's ``quantize`` bit for bit with nearest
rounding; ``quantize_jnp`` (:47) divides by qmax itself and can differ
from both in the scale's last bit. Stochastic rounding takes u from a
``torch.Generator`` (the kernel: Philox keyed by a seed drawn from it);
it matches JAX's draws only in distribution.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

import math

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda import builder

# the kernel's grid: about this many blocks of 256 threads (8 a SM), each
# at least MIN_CHUNK elements of one group; chunks are multiples of 8
# elements (16 bytes of bf16)
TARGET_BLOCKS = 1024
MIN_CHUNK = 2048
CHUNK_ALIGN = 8


def qrange(bits, sym):
    """(lowest code, highest code) as floats."""
    if sym:
        qmax = 2.0 ** (bits - 1) - 1
        return -qmax - 1, qmax
    return 0.0, 2.0 ** bits - 1


def rcp(bits, sym):
    """fp32(1 / qmax) (symmetric) or fp32(1 / (2^bits - 1)): the product
    XLA makes of the Pallas kernel's division by the constant."""
    d = qrange(bits, sym)[1]
    return float(np.float32(1.0 / d)) if d else math.inf


def _groups_view(x, groups):
    numel = x.numel()
    if numel % groups != 0:
        raise ValueError(f"numel {numel} not divisible by groups {groups}")
    return x.reshape(groups, numel // groups)


def qparams_plain(flat, bits, sym):
    """(scale [G, 1], zero [G, 1] or None) in fp32 of flat [G, n] fp32
    (``_quant_kernel``'s reductions; a NaN in a group propagates)."""
    r = torch.tensor(rcp(bits, sym), dtype=torch.float32, device=flat.device)
    if sym:
        scale, zero = flat.abs().amax(-1, keepdim=True) * r, None
    else:
        zero = flat.amin(-1, keepdim=True)
        scale = (flat.amax(-1, keepdim=True) - zero) * r
    return torch.where(scale == 0, 1.0, scale), zero


def apply_plain(flat, scale, zero, bits, u=None):
    """Round flat [G, n] fp32 at (scale, zero) to codes and back: nearest
    (half to even), or floor(t + u) with u [G, n] in [0, 1)."""
    lo, hi = qrange(bits, zero is None)
    t = flat / scale if zero is None else (flat - zero) / scale
    q = torch.round(t) if u is None else torch.floor(t + u)
    out = torch.clamp(q, lo, hi) * scale
    return out if zero is None else out + zero


def quantize_plain(x, bits=8, groups=1, sym=True, stochastic=False,
                   generator=None):
    """Grouped fake quantization in torch ops, in x's dtype; see the
    module docstring. Stochastic rounding draws u with ``torch.rand``
    from ``generator`` (None: the default one)."""
    flat = _groups_view(x, groups).float()
    scale, zero = qparams_plain(flat, bits, sym)
    u = torch.rand(flat.shape, generator=generator, device=flat.device) \
        if stochastic else None
    return apply_plain(flat, scale, zero, bits, u).reshape(x.shape).to(
        x.dtype)


def grid(groups, n):
    """(blocks a group, elements a block) of the kernel's grid."""
    nblk = max(1, min(-(-TARGET_BLOCKS // groups), -(-n // MIN_CHUNK)))
    chunk = -(-n // nblk)
    chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
    return -(-n // chunk), chunk


def quantize(x, bits=8, groups=1, sym=True, stochastic=False, generator=None,
             out=None):
    """Grouped fake quantization of x (any shape, [groups, n] flat) in
    x's dtype. On CUDA: fp32 or bf16, contiguous; ``out`` (x itself for
    in place, or None for a new tensor) receives the result; stochastic
    rounding keys the kernel's Philox by one int64 drawn from
    ``generator`` (None: the default CUDA generator), on the card."""
    fn = "quantize"
    if not 1 <= bits <= 16:
        raise ValueError(f"{fn}: bits must be 1..16, got {bits}")
    if x.device.type == "cpu":
        result = quantize_plain(x, bits, groups, sym, stochastic, generator)
        return result if out is None else out.copy_(result)
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    flat = _groups_view(x, groups)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{fn}: the CUDA kernel takes fp32 or bf16, "
                                  f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{fn}: out must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    n = flat.shape[1]
    if n == 0:
        return out
    nblk, chunk = grid(groups, n)
    if x.numel() >= 2 ** 31 or groups * nblk >= 2 ** 31:
        raise NotImplementedError(f"{fn}: the CUDA kernel takes fewer than "
                                  f"2^31 elements, got {x.numel()}")
    partial = torch.empty(groups * nblk * 2, dtype=torch.float32,
                          device=x.device)
    seed = None
    if stochastic:
        seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64,
                             generator=generator,
                             device=generator.device if generator is not None
                             else x.device).to(x.device)
    builder.kernels().call(
        "dstpu_quantize", x.data_ptr(), out.data_ptr(), partial.data_ptr(),
        None if seed is None else seed.data_ptr(), groups, n, nblk, chunk,
        bits, int(sym), int(stochastic), int(x.dtype == torch.bfloat16),
        rcp(bits, sym), torch.cuda.current_stream(x.device).cuda_stream)
    builder.launches[fn] += 1
    return out
