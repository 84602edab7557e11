"""The training transformer encoder layer, for the port.

Port of ``deepspeed_tpu/ops/transformer/transformer.py``:
``DeepSpeedTransformerConfig`` (:44), ``DeepSpeedTransformerLayer``
(:116) as an ``nn.Module`` with flax's parameter names (``attn_qkvw``,
``attn_ow``, ``inter_w``, ``output_w`` as ``kernel [in, out]`` + ``bias``;
``attn_nw``, ``norm_w`` as LayerNorm ``scale`` + ``bias``), pre-LN and
post-LN, exact gelu, ``adjust_init_range``, ``_canonical_mask`` (:227)
and ``transformer_layer``. Attention is the block-sparse op when the
config carries a ``sparsity_config`` (:156-166; masks take its
masked-dense path) and ``ops.attention.dot_product_attention``
otherwise (non-causal flash on CUDA, which takes no mask).

Not ported, raising ``NotImplementedError``: the remat knobs
(``normalize_invertible``, ``gelu_checkpoint``,
``attn_dropout_checkpoint``), which select a named-policy remat, and
dropout in training (``attn_dropout_ratio``/``hidden_dropout_ratio`` > 0
with ``deterministic=False``).
"""

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.attention import dot_product_attention
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
    SparseSelfAttention

ROADMAP_REMAT = ("ROADMAP.md queue 1, item \"Named remat policies, "
                 "dropout and an untied LM head\"")


@dataclasses.dataclass(frozen=True)
class DeepSpeedTransformerConfig:
    """The reference's layer config (transformer.py:95-142), as the JAX
    package reads it."""
    batch_size: int = -1            # parity only
    max_seq_length: int = -1        # parity only
    hidden_size: int = -1
    intermediate_size: int = -1     # -1 → 4 * hidden
    heads: int = -1
    attn_dropout_ratio: float = 0.0
    hidden_dropout_ratio: float = 0.0
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    local_rank: int = -1            # parity only
    seed: int = -1                  # parity only
    fp16: bool = False              # → bf16 compute
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True  # output-projection init / sqrt(2L)
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False   # no meaning here; accepted
    huggingface: bool = False
    training: bool = True
    dtype: Any = None               # explicit compute dtype
    param_dtype: Any = torch.float32
    sparsity_config: Any = None     # a SparsityConfig: block-sparse attention

    @property
    def compute_dtype(self):
        if self.dtype is not None:
            return self.dtype
        return torch.bfloat16 if self.fp16 else torch.float32

    @property
    def ffn_size(self):
        return self.intermediate_size if self.intermediate_size > 0 \
            else 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.heads


class Dense(nn.Module):
    """flax ``nn.Dense`` with ``dtype``/``param_dtype``: a master ``kernel
    [in, out]`` and ``bias``; input, kernel and bias cast to ``dtype`` for
    the product. ``std`` None is flax's default kernel init (lecun normal:
    a normal truncated at 2 sigma, variance 1 / in). ``use_bias=False`` is
    flax's ``use_bias=False``: no ``bias`` parameter at all."""

    def __init__(self, in_dim, features, std, dtype, param_dtype,
                 device=None, use_bias=True):
        super().__init__()
        self.std, self.dtype = std, dtype
        self.kernel = nn.Parameter(torch.empty(in_dim, features,
                                               dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(
            features, dtype=param_dtype, device=device)) if use_bias \
            else None

    def reset_parameters(self, generator):
        with torch.no_grad():
            if self.std is None:
                # variance_scaling's truncation correction for [-2, 2]
                std = math.sqrt(1.0 / self.kernel.shape[0]) \
                    / .87962566103423978
                nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
            else:
                self.kernel.normal_(0.0, self.std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.kernel.to(dt).t(),
                        None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics, scale and bias in fp32, the
    result in ``dtype``."""

    def __init__(self, dim, eps, dtype, param_dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.empty(dim, dtype=param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.empty(dim, dtype=param_dtype,
                                             device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale.float(),
                            self.bias.float(), self.eps).to(self.dtype)


def _canonical_mask(attention_mask):
    """(bias, segment_ids) from the two mask conventions, by shape
    (transformer.py:227-246): a 2-D [B, S] mask is a key-validity mask
    (1/True attend, 0/False pad) and becomes int32 segment ids; a 3-D or
    4-D mask is an additive bias broadcastable to [B, 1 or H, S, S]."""
    if attention_mask is None:
        return None, None
    m = torch.as_tensor(attention_mask)
    if m.dim() == 2:
        if m.dtype == torch.bool or m.dtype.is_floating_point:
            return None, (m.float() > 0.5).to(torch.int32)
        return None, m
    if m.dim() == 3:
        m = m[:, None]
    return m.float(), None


class DeepSpeedTransformerLayer(nn.Module):
    """The fused BERT-style encoder layer (transformer.py:116): hidden
    states [B, S, E] and an optional mask (see ``_canonical_mask``) →
    [B, S, E]. The parameters are made on ``device`` (default
    ``"meta"``); ``reset_parameters`` draws them from a
    ``torch.Generator`` with the JAX init: N(0, initializer_range), the
    two output projections / sqrt(2L) under ``adjust_init_range``, zero
    biases, LayerNorm 1/0. A sparse layout with random blocks is drawn at
    the layer's first call and kept."""

    def __init__(self, config: DeepSpeedTransformerConfig, device="meta"):
        super().__init__()
        cfg = self.config = config
        for knob in ("normalize_invertible", "gelu_checkpoint",
                     "attn_dropout_checkpoint"):
            if getattr(cfg, knob):
                raise NotImplementedError(
                    f"{knob} selects a named remat policy, which is not "
                    f"ported ({ROADMAP_REMAT})")
        E, dt, pdt = cfg.hidden_size, cfg.compute_dtype, cfg.param_dtype
        std = cfg.initializer_range
        out_std = std
        if cfg.adjust_init_range and cfg.num_hidden_layers > 0:
            out_std = std / math.sqrt(2.0 * cfg.num_hidden_layers)
        self.attn_qkvw = Dense(E, 3 * E, std, dt, pdt, device)
        self.attn_ow = Dense(E, E, out_std, dt, pdt, device)
        self.inter_w = Dense(E, cfg.ffn_size, std, dt, pdt, device)
        self.output_w = Dense(cfg.ffn_size, E, out_std, dt, pdt, device)
        self.attn_nw = LayerNorm(E, cfg.layer_norm_eps, dt, pdt, device)
        self.norm_w = LayerNorm(E, cfg.layer_norm_eps, dt, pdt, device)
        self.sparse = None if cfg.sparsity_config is None \
            else SparseSelfAttention(cfg.sparsity_config)

    def reset_parameters(self, generator):
        for m in (self.attn_qkvw, self.attn_ow, self.inter_w, self.output_w,
                  self.attn_nw, self.norm_w):
            m.reset_parameters(generator)

    def _attention(self, h, bias, segment_ids):
        cfg = self.config
        B, S, E = h.shape
        q, k, v = self.attn_qkvw(h).split(E, dim=-1)

        def heads(t):
            return t.reshape(B, S, cfg.heads, cfg.head_dim).transpose(1, 2)

        if self.sparse is not None:
            kpm = None if segment_ids is None else segment_ids != 0
            ctx = self.sparse(heads(q), heads(k), heads(v),
                              key_padding_mask=kpm)
        else:
            ctx = dot_product_attention(heads(q), heads(k), heads(v),
                                        causal=False, bias=bias,
                                        segment_ids=segment_ids)
        return self.attn_ow(ctx.transpose(1, 2).reshape(B, S, E))

    def _ffn(self, h):
        return self.output_w(F.gelu(self.inter_w(h)))

    def forward(self, hidden_states, attention_mask=None, deterministic=True):
        cfg = self.config
        if not deterministic and (cfg.attn_dropout_ratio > 0
                                  or cfg.hidden_dropout_ratio > 0):
            raise NotImplementedError(
                f"dropout in training (attn {cfg.attn_dropout_ratio}, "
                f"hidden {cfg.hidden_dropout_ratio}) is not ported "
                f"({ROADMAP_REMAT})")
        x = hidden_states.to(cfg.compute_dtype)
        bias, segment_ids = _canonical_mask(attention_mask)
        if cfg.pre_layer_norm:
            x = x + self._attention(self.attn_nw(x), bias, segment_ids)
            return x + self._ffn(self.norm_w(x))
        x = self.attn_nw(x + self._attention(x, bias, segment_ids))
        return self.norm_w(x + self._ffn(x))


def transformer_layer(config: DeepSpeedTransformerConfig, device="meta"):
    """The layer for ``config`` (transformer.py:249). The JAX package
    wraps it in a named-policy remat when a memory knob is set; the port
    raises there (see ``DeepSpeedTransformerLayer``)."""
    return DeepSpeedTransformerLayer(config, device)
