"""Quantizer op: port of ``deepspeed_tpu/ops/quantizer/__init__.py``
(the reference's ``deepspeed/ops/quantizer/quantizer.py``
``ds_quantizer``) and the storage quantizers of
``deepspeed_tpu/ops/pallas/quantize.py`` (``quantize_packed`` :145,
``dequantize_packed`` :161), bit for bit.

``quantize`` is the grouped fake-quantization kernel's wrapper
(``ops/cuda/quantize.py``): the CUDA kernel for a CUDA tensor, its plain
version for a CPU tensor.
"""

import torch

from deepspeed_tpu_torch.ops.cuda.quantize import quantize, quantize_plain


def ds_quantizer(input, groups=1, bit_num=8, sr=False, asym=False,
                 generator=None):
    """The reference API (ops/quantizer/quantizer.py:10-30): grouped fake
    quantization; ``sr`` = stochastic rounding (u from ``generator``),
    ``asym`` = asymmetric."""
    return quantize(input, bits=bit_num, groups=groups, sym=not asym,
                    stochastic=sr, generator=generator)


def _qparams_divided(flat, bits, sym):
    """``_qparams`` (quantize.py:31) as JAX runs it eagerly: the amax (or
    range) divided by qmax."""
    if sym:
        scale = flat.abs().amax(-1, keepdim=True) / (2.0 ** (bits - 1) - 1)
        zero = None
    else:
        zero = flat.amin(-1, keepdim=True)
        scale = (flat.amax(-1, keepdim=True) - zero) / (2.0 ** bits - 1)
    return torch.where(scale == 0, 1.0, scale), zero


def quantize_packed(x, bits=8, groups=1, sym=True):
    """Storage quantization → (codes, fp32 scales [G, 1], fp32 zeros [G, 1]
    or None): int8 codes (symmetric) or uint8 (asymmetric, [0, 2^bits - 1])
    of x [groups, n] flat."""
    if bits > 8:
        raise ValueError(f"quantize_packed stores at most 8 bits, got {bits}")
    flat = x.reshape(groups, -1).float()
    scale, zero = _qparams_divided(flat, bits, sym)
    if sym:
        qmax = 2.0 ** (bits - 1) - 1
        q = torch.clamp(torch.round(flat / scale), -qmax - 1, qmax)
        return q.to(torch.int8), scale, None
    q = torch.clamp(torch.round((flat - zero) / scale), 0, 2.0 ** bits - 1)
    return q.to(torch.uint8), scale, zero


def dequantize_packed(q, scale, zero, shape, dtype=torch.float32):
    flat = q.float() * scale
    if zero is not None:
        flat = flat + zero
    return flat.reshape(shape).to(dtype)


__all__ = ["ds_quantizer", "quantize", "quantize_plain", "quantize_packed",
           "dequantize_packed"]
