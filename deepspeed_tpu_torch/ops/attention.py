"""Attention dispatch: the CUDA flash kernels for CUDA tensors, the plain
PyTorch reference for CPU tensors.

Port of ``deepspeed_tpu/ops/attention.py``. Unlike the JAX dispatch, a
CUDA call never falls back: the kernel runs or the call raises. On CUDA
the forward and its backward are the flash kernels, joined by
``FlashAttentionFunction`` as ``jax.custom_vjp`` joins them at
``deepspeed_tpu/ops/pallas/flash_attention.py:521``.
"""

import math

import torch

from deepspeed_tpu_torch.ops.cuda import first_order_only
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd, flash_attention_fwd)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its recompute backward: the forward saves
    (q, k, v, o, lse) and the backward recomputes the scores from lse
    (``_flash_attention_fwd`` / ``_flash_attention_bwd``). On a CPU tensor
    both halves run their plain versions. The backward is not itself
    differentiable (lse and the kernels' outputs carry no graph): a
    second derivative through it raises instead of dropping the
    attention's second-order terms."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, scale=None):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @first_order_only
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def reference_attention(q, k, v, causal=False, bias=None, scale=None,
                        segment_ids=None):
    """Plain attention on [B, H, S, D] tensors (fp32 scores and softmax,
    probabilities cast to q's dtype before the V product). K/V may carry
    Hkv < H heads (grouped-query); they are repeated here."""
    B, H, S, D = q.shape
    if k.shape[1] != H:
        rep = H // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bhsd,bhtd->bhst", q, k).float() * scale
    if bias is not None:
        scores = scores + bias.float()
    neg = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
    if causal:
        keep = torch.ones(S, k.shape[2], dtype=torch.bool,
                          device=q.device).tril()
        scores = torch.where(keep[None, None], scores, neg)
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        scores = torch.where(seg, scores, neg)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(q.dtype), v)


def dot_product_attention(q, k, v, causal=False, bias=None, scale=None,
                          segment_ids=None):
    """[B, H, S, D] attention. CUDA tensors go to the flash kernels
    (differentiable through FlashAttentionFunction), which take no bias
    or segment ids; CPU tensors go to reference_attention, which
    autograd differentiates."""
    if q.device.type == "cuda":
        if bias is not None or segment_ids is not None:
            raise NotImplementedError(
                "dot_product_attention: the CUDA flash kernel takes no "
                "bias or segment_ids")
        return FlashAttentionFunction.apply(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal, scale)
    return reference_attention(q, k, v, causal=causal, bias=bias,
                               scale=scale, segment_ids=segment_ids)
