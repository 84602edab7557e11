"""Sparse-attention model integration, for the port.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``:
``BertSparseSelfAttention`` (an attention block computing QKV, then
block-sparse attention) and ``SparseAttentionUtils``: config rewriting
(``sparse_config_for``) in place of the reference's module surgery, the
position-embedding extension over the port's named tensors or a JAX
tree, and the padding of batches to a multiple of the block.
"""

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
    SparseSelfAttention
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
    FixedSparsityConfig
from deepspeed_tpu_torch.ops.transformer.transformer import Dense


class BertSparseSelfAttention(nn.Module):
    """BERT self-attention through the block-sparse op (reference
    bert_sparse_self_attention.py:9): [B, S, E] → [B, S, E] context,
    before the output projection. Its one parameter block is ``qkv``
    (``kernel [E, 3E]``, ``bias``), flax's name. ``attention_mask`` is a
    [B, S] key-padding mask, which takes the masked-dense path."""

    def __init__(self, hidden_size, num_attention_heads, sparsity_config,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 initializer_range=0.02, device="meta"):
        super().__init__()
        assert hidden_size % num_attention_heads == 0
        self.hidden_size, self.heads = hidden_size, num_attention_heads
        self.qkv = Dense(hidden_size, 3 * hidden_size, initializer_range,
                         dtype, param_dtype, device)
        self.op = SparseSelfAttention(sparsity_config)

    def reset_parameters(self, generator):
        self.qkv.reset_parameters(generator)

    def forward(self, hidden_states, attention_mask=None):
        B, S, E = hidden_states.shape
        q, k, v = self.qkv(hidden_states).split(E, dim=-1)

        def heads(t):
            return t.reshape(B, S, self.heads, E // self.heads).transpose(1, 2)

        ctx = self.op(heads(q), heads(k), heads(v),
                      key_padding_mask=attention_mask)
        return ctx.transpose(1, 2).reshape(B, S, E)


def _tile_rows(leaf, max_position):
    rows = leaf.shape[0]
    if max_position <= rows:
        return leaf
    reps = int(math.ceil(max_position / rows))
    if torch.is_tensor(leaf):
        return leaf.repeat(reps, 1)[:max_position]
    return np.tile(np.asarray(leaf), (reps, 1))[:max_position]


class SparseAttentionUtils:
    """Helpers mirroring the reference SparseAttentionUtils API."""

    POSITION_TABLES = ("position_embeddings", "wpe")

    @staticmethod
    def extend_position_embedding(params, max_position):
        """``params`` with every position-embedding table extended to
        ``max_position`` rows by tiling the learned table (reference
        sparse_attention_utils.py:52-80). ``params`` is the port's named
        tensors (``{"bert.embeddings.position_embeddings": t, ...}``, a
        state dict) or a JAX-layout nested dict: a leaf whose name (its
        key's last dotted part) is ``position_embeddings`` (BERT) or
        ``wpe`` (GPT-2) is extended, every other leaf is kept."""
        out = {}
        for key, value in params.items():
            if isinstance(value, dict):
                out[key] = SparseAttentionUtils.extend_position_embedding(
                    value, max_position)
            elif key.split(".")[-1] in SparseAttentionUtils.POSITION_TABLES:
                out[key] = _tile_rows(value, max_position)
            else:
                out[key] = value
        return out

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position):
        """Bump a HF-style tokenizer's max length (reference :82-96)."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def sparse_config_for(bert_config, sparsity_config=None):
        """A copy of ``bert_config`` with the sparse layout attached, in
        place of the reference's module surgery (:98-153): every encoder
        layer then routes attention through the block-sparse op."""
        sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=bert_config.num_attention_heads)
        return dataclasses.replace(bert_config,
                                   sparsity_config=sparsity_config)

    @staticmethod
    def pad_to_block_size(block_size, input_ids=None, attention_mask=None,
                          token_type_ids=None, position_ids=None,
                          inputs_embeds=None, pad_token_id=0,
                          model_embeddings=None):
        """Pad the sequence dim up to a multiple of ``block_size``
        (reference :155-211): (pad_len, the padded tensors in the same
        order). ``model_embeddings`` is accepted for signature parity and
        unused (the model embeds its own ids)."""
        seqs = [t for t in (input_ids, attention_mask, token_type_ids,
                            position_ids, inputs_embeds) if t is not None]
        assert seqs, "nothing to pad"
        pad_len = (block_size - seqs[0].shape[1] % block_size) % block_size

        def pad(t, value=0):
            if t is None or pad_len == 0:
                return t
            widths = [0, 0] * (t.dim() - 2) + [0, pad_len]
            return F.pad(t, widths, value=value)

        return (pad_len,
                pad(input_ids, pad_token_id),
                pad(attention_mask, 0),       # padded keys masked out
                pad(token_type_ids, 0),
                pad(position_ids, 0),
                pad(inputs_embeds, 0))

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Strip the block padding from the model output (reference
        :213-222)."""
        if pad_len:
            return sequence_output[:, :-pad_len]
        return sequence_output
