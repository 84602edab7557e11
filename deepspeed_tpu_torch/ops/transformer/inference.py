"""Fused inference transformer layer with a KV cache.

Port of ``deepspeed_tpu/ops/transformer/inference.py``, the rebuild's
counterpart of DeepSpeed-Inference's kernel-injected layer:
``DeepSpeedInferenceConfig`` (:38), ``QuantDense``'s dequantized product
(:110-142), ``DeepSpeedTransformerInference`` (:160) with its fused
int8 decode step (:234) and cached attention (:350), ``_as_bias`` (:453)
and ``quantize_inference_params`` (:471). ``inference_tp_specs`` (tensor
parallel serving) is not ported.

One module serves the prompt pass and single-token decode steps. Its
weights are one layer's tensors (a dict of views, in the port's GPT-2
names) and its KV cache is explicit state, ``KVCache``: the counterpart
of flax's ``cache`` collection, layer-stacked ``[Lyr, B, H, L, D]`` (int8
codes with ``[Lyr, B, H, L]`` fp32 scales, or the activations' dtype) and
one ``cache_index``, a one-element int32 tensor on the device that the
caller advances after a pass through every layer.

Routes, as JAX takes them:

- with ``quantize_bits=8, kv_cache_bits=8`` a decode step (S == 1, no
  mask, B <= 8, ``quantize_groups`` 1, E and F multiples of 128) runs
  three kernels a layer: ``ln_qkv_int8``, ``decode_attention_int8``
  (which writes the new rows' int8 codes into the cache in place first,
  kv_quant_int8's arithmetic inside the attention kernel) and
  ``out_ffn_int8``;
- otherwise the general path: dense products (int8 codes dequantized
  first, as ``QuantDense`` does) and ``_attend``, which over an int8
  cache at S == 1 (no mask, B <= 8) runs ``decode_attention_int8`` and
  else computes the masked scores over the whole cache length, as XLA
  does in JAX (in chunks of one batch row, so the fp32 scores of a long
  prompt stay one row's);
- with no cache (or no triangular mask): an encoder layer through
  ``ops.attention.dot_product_attention``.
"""

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.attention import dot_product_attention
from deepspeed_tpu_torch.ops.cuda.decode import (decode_attention_int8,
                                                 ln_qkv_int8, out_ffn_int8,
                                                 quantize_rows)

ROADMAP_MOE = "ROADMAP.md queue 1, item \"Remaining models\""
ROADMAP_TP = "ROADMAP.md queue 1, item \"Multi-GPU ZeRO-3 stream\""
# the layer's four projections (port name → its bias's name); int8 codes
# carry their scales as name + SCALE
WEIGHTS = {"attn_qkvw": "attn_qkvb", "attn_ow": "attn_ob",
           "inter_w": "inter_b", "output_w": "output_b"}
SCALE = "_scale"


@dataclasses.dataclass(frozen=True)
class DeepSpeedInferenceConfig:
    """The parity surface of DeepSpeed-Inference's config
    (``inference.py:38-105``): widths, LayerNorm placement, masking, the
    cache length and the int8 weight and KV-cache storage. ``dtype`` is a
    torch dtype (None: bf16 with ``fp16``, else fp32). MoE layers and
    ``mp_size > 1`` are not ported and raise."""
    hidden_size: int = -1
    intermediate_size: int = -1          # -1 → 4*hidden
    heads: int = -1
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = True
    fp16: bool = False                   # → bf16 compute
    mp_size: int = 1
    triangular_masking: bool = True      # causal (decoder) vs encoder
    max_out_tokens: int = 1024           # KV cache length
    gelu_approximate: bool = False       # tanh-approx GELU (GPT-2) vs exact
    quantize_bits: int = 0               # 0 = off; 8 = int8 storage
    quantize_groups: int = 1
    moe_experts: int = 0
    moe_k: int = 1
    moe_capacity_factor: float = 1.25
    kv_cache_bits: int = 0               # 0 = off; 8 = int8 storage
    dtype: Any = None
    param_dtype: Any = torch.float32

    def __post_init__(self):
        if self.kv_cache_bits not in (0, 8):
            raise ValueError(
                f"kv_cache_bits must be 0 (off) or 8 (int8 storage), got "
                f"{self.kv_cache_bits} — silently serving a full-precision "
                f"cache would defeat the memory sizing the caller did")
        if self.quantize_bits not in (0, 8):
            raise ValueError(
                f"quantize_bits must be 0 or 8, got {self.quantize_bits}")
        if self.moe_experts > 0:
            raise NotImplementedError(
                f"MoE inference layers (moe_experts={self.moe_experts}) are "
                f"not ported ({ROADMAP_MOE})")
        if self.mp_size > 1:
            raise NotImplementedError(
                f"tensor-parallel inference (mp_size={self.mp_size}) is not "
                f"ported ({ROADMAP_TP})")

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


@dataclasses.dataclass
class KVCache:
    """The KV cache of inference layers: ``k``, ``v`` [Lyr, B, H, L, D]
    (int8 codes with ``k_scale``, ``v_scale`` [Lyr, B, H, L] fp32, or the
    activations' dtype with no scales) and ``index``, the next position
    to write (JAX's ``cache_index``), a one-element int32 tensor on the
    device. ``layer(l)`` is layer l's cache: contiguous views [B, H, L,
    D] sharing ``index``."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Any
    v_scale: Any
    index: torch.Tensor

    @classmethod
    def zeros(cls, n_layers, batch, heads, length, head_dim, dtype,
              kv_cache_bits, device):
        """A zero-filled cache; int8 codes and scales with
        ``kv_cache_bits == 8``, else ``dtype``."""
        shape = (n_layers, batch, heads, length, head_dim)
        q8 = kv_cache_bits == 8
        kdt = torch.int8 if q8 else dtype

        def scales():
            return torch.zeros(shape[:4], device=device) if q8 else None
        return cls(torch.zeros(shape, dtype=kdt, device=device),
                   torch.zeros(shape, dtype=kdt, device=device), scales(),
                   scales(), torch.zeros(1, dtype=torch.int32, device=device))

    @property
    def q8(self):
        return self.k_scale is not None

    @property
    def length(self):
        return self.k.shape[-2]

    def layer(self, l):
        return dataclasses.replace(
            self, k=self.k[l], v=self.v[l],
            k_scale=None if self.k_scale is None else self.k_scale[l],
            v_scale=None if self.v_scale is None else self.v_scale[l])

    def stacks(self):
        """The stacked tensors as the decode kernels take them: (k codes,
        k scale [Lyr, B, H, 1, L], v codes, v scale) or (k, v)."""
        if self.q8:
            return (self.k, self.k_scale.unsqueeze(-2), self.v,
                    self.v_scale.unsqueeze(-2))
        return self.k, self.v

    def advance(self, n):
        """Move ``index`` past ``n`` written positions (in place)."""
        self.index.add_(n)


def layer_norm(x, w, b, eps):
    """fp32 LayerNorm, result in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def dequantize(codes, scale, dtype):
    """int8 codes [in, out] (or [L, in, out]) and their group scales
    ([groups, 1], or [L, groups, 1]) → (codes · scale) in ``dtype``, the
    product in fp32 (``QuantDense``, inference.py:138)."""
    lead = codes.shape[:-2]
    g = scale.shape[-2]
    w = codes.float().reshape(*lead, g, -1) * scale.float()
    return w.reshape(codes.shape).to(dtype)


def _dense(x, w, name, cfg):
    """x · W + b in x's dtype; int8 codes are dequantized first."""
    k = w[name]
    if cfg.quantize_bits:
        k = dequantize(k, w[name + SCALE], x.dtype)
    return x @ k.to(x.dtype) + w[WEIGHTS[name]].to(x.dtype)


def _as_bias(attention_mask, L):
    """[B, S_k] validity mask or [B, 1, 1, S_k] / [B, 1, S_q, S_k] additive
    bias → additive fp32 bias padded or cropped to key length L."""
    m = torch.as_tensor(attention_mask)
    if m.dim() == 2:
        m = (1.0 - (m > 0.5).float())[:, None, None, :] * -1e30
    elif m.dim() == 3:
        m = m[:, None].float()
    else:
        m = m.float()
    k_len = m.shape[-1]
    if k_len < L:
        m = F.pad(m, (0, L - k_len))
    elif k_len > L:
        m = m[..., :L]
    return m


class DeepSpeedTransformerInference(nn.Module):
    """Inference encoder/decoder layer with an optional KV cache.

    ``forward(hidden_states [B, S, E], w, cache=None, attention_mask=None)``
    with ``w`` the layer's weights (``ln1_w``/``ln1_b``, ``attn_qkvw``
    [E, 3E] and ``attn_qkvb``, ``attn_ow``/``attn_ob``, ``ln2_w``/``ln2_b``,
    ``inter_w``/``inter_b``, ``output_w``/``output_b``; with
    ``quantize_bits=8`` the four matrices are int8 codes with
    ``<name>_scale`` [groups, 1]) and ``cache`` one layer's ``KVCache``.
    The layer writes its rows at ``cache.index`` and never advances it.
    """

    def __init__(self, config: DeepSpeedInferenceConfig):
        super().__init__()
        self.config = config

    def forward(self, hidden_states, w, cache=None, attention_mask=None):
        cfg = self.config
        B, S, E = hidden_states.shape
        x = hidden_states.to(cfg.compute_dtype)
        if (cfg.quantize_bits == 8 and cfg.kv_cache_bits == 8 and S == 1
                and attention_mask is None and cfg.pre_layer_norm
                and cfg.triangular_masking and cfg.quantize_groups == 1
                and B <= 8 and E % 128 == 0 and cfg.ffn_size % 128 == 0
                and cache is not None):
            return self._decode_step_fused(x, w, cache)
        eps = cfg.layer_norm_eps
        H, D = cfg.heads, cfg.head_dim

        def attn(h):
            qkv = _dense(h, w, "attn_qkvw", cfg)
            q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(E, -1))
            ctx = self._attend(q, k, v, cache, attention_mask)
            return _dense(ctx.reshape(B, S, E), w, "attn_ow", cfg)

        def ffn(h):
            inter = F.gelu(_dense(h, w, "inter_w", cfg),
                           approximate="tanh" if cfg.gelu_approximate
                           else "none")
            return _dense(inter, w, "output_w", cfg)

        if cfg.pre_layer_norm:
            x = x + attn(layer_norm(x, w["ln1_w"], w["ln1_b"], eps))
            x = x + ffn(layer_norm(x, w["ln2_w"], w["ln2_b"], eps))
        else:
            x = layer_norm(x + attn(x), w["ln1_w"], w["ln1_b"], eps)
            x = layer_norm(x + ffn(x), w["ln2_w"], w["ln2_b"], eps)
        return x

    def _decode_step_fused(self, x, w, cache):
        """The int8 serving step (``_decode_step_fused``, inference.py:234):
        ln_qkv_int8, decode_attention_int8 writing the new rows' int8
        codes into the cache at ``cache.index`` (kv_quant_int8's
        arithmetic, inside the attention kernel) and attending over rows
        0..index, and out_ffn_int8. Past the cache's end x is NaN, as in
        JAX."""
        cfg = self.config
        B, _, E = x.shape
        H, D, L = cfg.heads, cfg.head_dim, cache.length
        eps = cfg.layer_norm_eps
        start = cache.index
        x2 = torch.where(start >= L, torch.tensor(
            float("nan"), dtype=x.dtype, device=x.device), x.reshape(B, E))
        qkv = ln_qkv_int8(x2, w["ln1_w"], w["ln1_b"], w["attn_qkvw"],
                          w["attn_qkvw" + SCALE].reshape(1), w["attn_qkvb"],
                          eps=eps)
        # the kernel writes the new rows' codes and scales at min(start,
        # L - 1) first, as dynamic_update_slice clamps the write
        ctx = decode_attention_int8(
            qkv[:, :E].reshape(B, H, 1, D).contiguous(), cache.k,
            cache.k_scale, cache.v, cache.v_scale, start,
            scale=1.0 / math.sqrt(D), new_k=qkv[:, E:2 * E].view(B, H, D),
            new_v=qkv[:, 2 * E:].view(B, H, D))
        y = out_ffn_int8(
            ctx.reshape(B, E), x2, w["attn_ow"], w["attn_ow" + SCALE].reshape(1),
            w["attn_ob"], w["ln2_w"], w["ln2_b"], w["inter_w"],
            w["inter_w" + SCALE].reshape(1), w["inter_b"], w["output_w"],
            w["output_w" + SCALE].reshape(1), w["output_b"],
            act="gelu_tanh" if cfg.gelu_approximate else "gelu", eps=eps)
        return y.reshape(B, 1, E)

    def _cache_write(self, kh, vh, cache):
        """Write the new rows kh, vh [B, H, S, D] at ``cache.index`` (the
        offset clamped to L - S, as dynamic_update_slice clamps it): int8
        codes and scales over an int8 cache (``_cache_int8``,
        inference.py:304), else the rows as they are."""
        S = kh.shape[2]
        rows = torch.clamp(cache.index, max=cache.length - S).long() \
            + torch.arange(S, device=kh.device)
        if cache.q8:
            for t, codes, scales in ((kh, cache.k, cache.k_scale),
                                     (vh, cache.v, cache.v_scale)):
                c, sc = quantize_rows(t)
                codes.index_copy_(2, rows, c)
                scales.index_copy_(2, rows, sc[..., 0])
        else:
            cache.k.index_copy_(2, rows, kh.to(cache.k.dtype))
            cache.v.index_copy_(2, rows, vh.to(cache.v.dtype))

    def _attend(self, q, k, v, cache, attention_mask):
        """[B, S, H, D] q/k/v → [B, S, H, D] context, through the KV cache
        when the layer is a decoder with one (``_attend``,
        inference.py:350-450)."""
        cfg = self.config
        B, S, H, D = q.shape
        scale = 1.0 / math.sqrt(D)
        if not (cfg.triangular_masking and cache is not None):
            bias = _as_bias(attention_mask, S) \
                if attention_mask is not None else None
            ctx = dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=cfg.triangular_masking, bias=bias, scale=scale)
            return ctx.transpose(1, 2)
        L = cache.length
        self._cache_write(k.transpose(1, 2), v.transpose(1, 2), cache)
        start = cache.index
        # overflow: a clamped write would serve stale context; poison
        q = torch.where(start + S > L, torch.tensor(
            float("nan"), dtype=q.dtype, device=q.device), q)
        qh = q.transpose(1, 2)                           # [B, H, S, D]
        if cache.q8 and S == 1 and attention_mask is None and B <= 8:
            ctx = decode_attention_int8(qh.contiguous(), cache.k,
                                        cache.k_scale, cache.v, cache.v_scale,
                                        start, scale=scale)
            return ctx.transpose(1, 2)
        # query i (absolute start + i) sees key j <= start + i, over the
        # whole cache length; one batch row's [H, S, L] scores at a time
        q_pos = start + torch.arange(S, device=q.device)[:, None]
        visible = torch.arange(L, device=q.device)[None, :] <= q_pos
        bias = _as_bias(attention_mask, L) \
            if attention_mask is not None else None
        neg = torch.tensor(-1e30, device=q.device)
        out = torch.empty_like(qh)
        for b in range(B):
            kb = cache.k[b].to(q.dtype)
            scores = (qh[b] @ kb.transpose(1, 2)).float()
            if cache.q8:
                scores = scores * cache.k_scale[b][:, None, :]
            scores = torch.where(visible, scores * scale, neg)
            if bias is not None:
                scores = scores + bias[b if bias.shape[0] > 1 else 0]
            probs = torch.softmax(scores, dim=-1)
            if cache.q8:
                probs = probs * cache.v_scale[b][:, None, :]
            out[b] = probs.to(q.dtype) @ cache.v[b].to(q.dtype)
        return out.transpose(1, 2)


def quantize_weight(w, groups=1):
    """Symmetric int8 codes of a matrix [in, out] or a layer stack [L, in,
    out] in ``groups`` groups a matrix: (codes int8 of w's shape, scales
    fp32 [groups, 1] or [L, groups, 1]) with scale = max(amax / 127,
    1e-12), a true division, and codes = clip(round(w / scale), -128, 127)
    in fp32 (``quantize_inference_params``, inference.py:471-513). A stack
    is quantized one layer at a time."""
    if w.dim() == 3:
        parts = [quantize_weight(m, groups) for m in w]
        return (torch.stack([c for c, _ in parts]),
                torch.stack([s for _, s in parts]))
    flat = w.reshape(groups, -1).float()
    amax = flat.abs().amax(1, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    codes = torch.clamp(torch.round(flat / scale), -128, 127)
    return codes.to(torch.int8).reshape(w.shape), scale


def quantize_inference_params(params, bits=8, groups=1):
    """Fused-layer params → int8-storage params for ``quantize_bits``
    serving: every ``kernel`` under the four weight names (``attn_qkvw``,
    ``attn_ow``, ``inter_w``, ``output_w``) of a nested dict of tensors
    becomes ``kernel_q`` (int8, same shape) + ``kernel_scale`` ([groups,
    1] fp32, or [L, groups, 1] for a layer stack); biases and everything
    else stay as they are (``quantize_inference_params``,
    inference.py:471)."""
    assert bits == 8, "int8 storage only"

    def convert(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for key, sub in tree.items():
            if key in WEIGHTS and isinstance(sub, dict) and "kernel" in sub:
                codes, scale = quantize_weight(torch.as_tensor(sub["kernel"]),
                                               groups)
                out[key] = {"kernel_q": codes, "kernel_scale": scale,
                            "bias": sub["bias"]}
            else:
                out[key] = convert(sub)
        return out

    return convert(params)
