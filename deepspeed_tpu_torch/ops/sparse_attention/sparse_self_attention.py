"""Block-sparse self-attention: the dispatch and the module.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``:
softmax(QKᵀ)V restricted to a static block layout, on [B, H, S, D]
tensors. The dispatch is the JAX package's, written out:

- no ``key_padding_mask``/``attn_mask`` → the block-sparse kernels
  (``ops/cuda/blocksparse.py``): the CUDA kernels on a CUDA tensor, their
  plain versions on a CPU tensor;
- a mask → the masked-dense path (:97-113), as the JAX package takes on
  the TPU whenever a mask is given (the kernel raises on masks there and
  the dispatch falls back); its calls are counted as
  ``sparse_attention_dense``;
- ``use_kernel=True`` with a mask raises, as ``blocksparse.py:469-470``
  does; ``use_kernel=False`` takes the masked-dense path.

The JAX dispatch also weighs the kernel against the dense path with a
crossover measured on a TPU v5e (``_kernel_beats_dense``, :28-54). Those
constants say nothing of an H100, so the port does not copy it: on CUDA
the kernel runs whenever no mask is given. A crossover measured on the
H100 is later work (ROADMAP.md queue 2, item "block-sparse attention:
masks, other head dims and blocks, fp32").
"""

import math

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda import builder
from deepspeed_tpu_torch.ops.cuda.blocksparse import blocksparse_attention
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig, SparsityConfig)


def _expand_layout_mask(layout, block, seq_len, device):
    """[H, nb, nb] 0/1 block layout → [H, S, S] boolean element mask."""
    nb = seq_len // block
    layout = np.asarray(layout)[:, :nb, :nb]
    mask = np.repeat(np.repeat(layout, block, axis=1), block, axis=2)
    return torch.from_numpy(mask.astype(bool)).to(device)


def masked_dense_attention(q, k, v, layout, block, key_padding_mask=None,
                           attn_mask=None, scale=None):
    """The dense path (sparse_self_attention.py:97-113): [B, H, S, S]
    scores masked by the expanded layout and the masks, fp32 softmax,
    probabilities in q's dtype; a row with no allowed key gives zeros."""
    B, H, S, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    mask = _expand_layout_mask(layout, block, S, q.device)
    scores = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    neg = torch.finfo(scores.dtype).min
    scores = scores.masked_fill(~mask[None], neg)
    if attn_mask is not None:
        scores = scores.masked_fill(~attn_mask.bool(), neg)
    if key_padding_mask is not None:
        scores = scores.masked_fill(
            ~key_padding_mask[:, None, None, :].bool(), neg)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    probs = torch.where(mask.any(dim=-1)[None, :, :, None], probs, 0.0)
    return torch.einsum("bhst,bhtd->bhsd", probs, v)


def sparse_attention(q, k, v, layout, block, key_padding_mask=None,
                     attn_mask=None, scale=None, use_kernel=None):
    """[B, H, S, D] attention with a static block-sparse ``layout`` [H or
    1, S//block, S//block], differentiable on both paths. See the module
    docstring for the dispatch."""
    masked = key_padding_mask is not None or attn_mask is not None
    if use_kernel and masked:
        raise NotImplementedError("mask args use the dense fallback path")
    if use_kernel is None:
        use_kernel = not masked
    if use_kernel:
        return blocksparse_attention(q, k, v, layout, block, scale=scale)
    builder.launches["sparse_attention_dense"] += 1
    return masked_dense_attention(q, k, v, layout, block, key_padding_mask,
                                  attn_mask, scale)


class SparseSelfAttention:
    """Holds a SparsityConfig, makes its layout once per sequence length
    and applies sparse attention to [B, H, S, D] q/k/v (the reference
    class, sparse_self_attention.py:14). A layout with random blocks is
    drawn at its first use and kept, so every later call (and the kernel
    tables made from it) sees the same one."""

    def __init__(self, sparsity_config=None, key_padding_mask_mode="add",
                 attn_mask_mode="mul", max_seq_length=2048):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=4)
        assert isinstance(self.sparsity_config, SparsityConfig)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._layout_cache = {}

    def get_layout(self, seq_len):
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = self.sparsity_config.make_layout(
                seq_len)
        return self._layout_cache[seq_len]

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None):
        assert query.dtype in (torch.float32, torch.bfloat16,
                               torch.float16), (
            "sparse attention supports float dtypes")
        layout = self.get_layout(query.shape[-2])
        return sparse_attention(query, key, value, layout,
                                self.sparsity_config.block,
                                key_padding_mask=key_padding_mask,
                                attn_mask=attn_mask)
