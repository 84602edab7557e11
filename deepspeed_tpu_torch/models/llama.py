"""LLaMA: configuration, presets, RoPE, RMSNorm, the training model and
its generate.

Port of ``deepspeed_tpu/models/llama.py``: ``LlamaConfig`` (:41), the
presets ``llama_tiny`` (:429), ``llama_7b`` (:437) and ``llama3_8b``
(:444), ``rope_angles`` (:92), ``apply_rope`` (:100), ``RMSNorm``
(:77-89), ``LlamaAttention``, ``LlamaMLP``, ``LlamaBlock`` and
``LlamaForCausalLM`` (:107-317) as ``nn.Module``s, and ``llama_generate``
(:320-392); ``rope_tables``/``rope_rows`` rotate the serving ticks'
single rows. The training model keeps flax's parameter names and ``[in,
out]`` kernels, so its bridge (``jax_tree`` / ``from_jax_tree``) carries a
JAX training tree across leaf by leaf in the scan-stacked ``layers/blk``
layout or the unrolled ``layers_{i}`` one, and a trained tree packs into
the serving weights of ``models/llama_inference.py``.

GQA (``n_kv_heads < n_heads``): K/V are projected and cached at the
reduced head count and go into the attention at Hkv heads; the flash
forward folds the query heads onto their KV head, the flash backward
repeats K/V and sums dk/dv back (``ops/cuda/flash_attention.py`` ``_bwd``).

Not ported, raising ``NotImplementedError``: the named remat policies
(``remat_policy`` other than None), bf16 master parameters, and the
sequence-parallel attention over a mesh seq axis (ring / Ulysses, whose
mesh ``parallel/mesh.make_mesh`` refuses).
"""

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.gpt2 import (ROADMAP_REMAT, chunked_lm_loss,
                                             lm_loss)
from deepspeed_tpu_torch.models.jax_bridge import JaxTreeBridge
from deepspeed_tpu_torch.ops.attention import (dot_product_attention,
                                               reference_attention)
from deepspeed_tpu_torch.ops.transformer.transformer import Dense
from deepspeed_tpu_torch.utils.sampling import pick_token


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 0              # 0 → MHA (= n_heads); < n_heads → GQA
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16      # activation/compute dtype
    param_dtype: Any = torch.float32  # master parameters (fp32 only)
    remat: bool = False              # full block recompute in the backward
    remat_policy: Optional[str] = None  # None = full block recompute
    # the JAX training tree's layout (``layers/blk/...`` when True)
    scan_layers: bool = True
    # False: plain attention (reference_attention) on every device; None
    # or True: ops.attention.dot_product_attention (flash on CUDA)
    use_flash: Optional[bool] = None
    # fused head + loss in chunks of this many tokens (no [B, S, V]); 0 = off
    loss_chunk: int = 0

    @property
    def kv_heads(self):
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.n_heads

    def num_params(self):
        E, F, L, V = (self.hidden_size, self.intermediate_size,
                      self.n_layers, self.vocab_size)
        Dkv = self.kv_heads * self.head_dim
        per_layer = E * E + 2 * E * Dkv + E * E + 3 * E * F + 2 * E
        return 2 * V * E + L * per_layer + E


def llama_tiny(**over):
    kw = dict(vocab_size=512, hidden_size=128, intermediate_size=352,
              n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=128,
              dtype=torch.float32)
    kw.update(over)
    return LlamaConfig(**kw)


def llama_7b(**over):
    kw = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
              n_layers=32, n_heads=32, max_seq_len=2048)
    kw.update(over)
    return LlamaConfig(**kw)


def llama3_8b(**over):
    kw = dict(vocab_size=128256, hidden_size=4096,
              intermediate_size=14336, n_layers=32, n_heads=32,
              n_kv_heads=8, max_seq_len=8192, rope_theta=500000.0)
    kw.update(over)
    return LlamaConfig(**kw)


def rope_angles(positions, head_dim, theta):
    """[S] positions → (cos, sin) [S, head_dim // 2] fp32."""
    dev = positions.device
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=dev) / head_dim))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Rotary embedding on [B, H, S, D], split-halves convention, with
    cos/sin cast to x's dtype before the products (as JAX does)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, None].to(x.dtype)
    s = sin[None, None].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rope_tables(pos, D, theta, dtype):
    """RoPE tables [B, 1, D] in ``dtype`` at per-row positions ``pos`` [B],
    made once a decode step for every layer: (cos | cos) and (-sin | sin)
    of ``rope_angles``, cast to the rows' dtype as JAX casts them."""
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=pos.device) / D))
    ang = pos.float()[:, None, None] * inv                # [B, 1, D//2]
    cos, sin = torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def rope_rows(x, cos2, sin2):
    """RoPE on [B, Hx, D] rows (split halves x1 | x2) with ``rope_tables``:
    x * (cos | cos) + (x2 | x1) * (-sin | sin) rounds where JAX's (x1*cos -
    x2*sin | x2*cos + x1*sin) does, bit for bit (the decode ticks'
    ``_rope_rows`` of serving/adapters.py:692 and ``_rope_one`` of
    models/llama_inference.py:130)."""
    half = x.shape[-1] // 2
    return x * cos2 + torch.cat([x[..., half:], x[..., :half]], -1) * sin2


def rms_norm(x, w, eps):
    """RMSNorm with fp32 statistics, the result in x's dtype."""
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


# -- the training model ------------------------------------------------------

class RMSNorm(nn.Module):
    """flax ``RMSNorm`` (llama.py:77): an fp32 ``scale`` (init 1),
    statistics in fp32, the result in ``dtype``."""

    def __init__(self, dim, eps, dtype, param_dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.empty(dim, dtype=param_dtype,
                                              device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps).to(self.dtype)


def _dense(cfg, in_dim, features, device):
    """flax ``nn.Dense(use_bias=False)`` with a normal(0.02) kernel."""
    return Dense(in_dim, features, 0.02, cfg.dtype, cfg.param_dtype, device,
                 use_bias=False)


def _rms_norm(cfg, device):
    return RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, cfg.param_dtype,
                   device)


class LlamaKVCache:
    """``llama_generate``'s decode cache (the flax "cache" collection):
    one head-major [B, Hkv, L, D] K and V a layer, and ``index``, the
    position the next tokens are written at."""

    def __init__(self, cfg, batch, length, dtype, device):
        shape = (batch, cfg.kv_heads, length, cfg.head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.n_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.n_layers)]
        self.index = 0


class LlamaAttention(nn.Module):
    """Grouped-query causal self-attention with RoPE (llama.py:107).
    ``attention`` is the [B, H, S, D] attention function it calls, K/V at
    Hkv heads (``ops.attention.dot_product_attention``; with
    ``use_flash=False`` ``reference_attention``); an instance may be given
    another with the same signature, such as a reference to check the
    kernels against."""

    attention = staticmethod(dot_product_attention)

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        E, H, Hkv, D = (cfg.hidden_size, cfg.n_heads, cfg.kv_heads,
                        cfg.head_dim)
        self.q_proj = _dense(cfg, E, H * D, device)
        self.k_proj = _dense(cfg, E, Hkv * D, device)
        self.v_proj = _dense(cfg, E, Hkv * D, device)
        self.o_proj = _dense(cfg, H * D, E, device)

    def forward(self, x, cos, sin, cache=None, layer=None):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim

        def heads(t, n):
            return t.reshape(B, S, n, D).transpose(1, 2)
        qh = apply_rope(heads(self.q_proj(x), H), cos, sin)
        kh = apply_rope(heads(self.k_proj(x), Hkv), cos, sin)
        vh = heads(self.v_proj(x), Hkv)
        if cache is None:
            attend = reference_attention if cfg.use_flash is False \
                else self.attention
            out = attend(qh, kh, vh, causal=True)
        else:
            out = self._cached(qh, kh, vh, cache, layer)
        return self.o_proj(out.transpose(1, 2).reshape(B, S, H * D))

    def _cached(self, qh, kh, vh, cache, layer):
        """The serving branch (llama.py:137-185): append the RoPE'd K/V to
        the layer's head-major cache at ``cache.index`` and attend over the
        filled prefix, the rep = H / Hkv query heads that share a KV head
        folded into the rows (no repeated cache); q is NaN on overflow."""
        B, H, S, D = qh.shape
        ck, cv = cache.k[layer], cache.v[layer]
        Hkv, L = ck.shape[1], ck.shape[2]
        start = cache.index
        at = max(0, min(start, L - S))   # dynamic_update_slice clamps
        ck[:, :, at:at + S] = kh
        cv[:, :, at:at + S] = vh
        if start + S > L:
            qh = torch.full_like(qh, float("nan"))
        rep = H // Hkv
        qg = qh.reshape(B, Hkv, rep * S, D)
        q_pos = start + torch.arange(S, device=qh.device)[:, None]
        visible = torch.arange(L, device=qh.device)[None, :] <= q_pos
        vis_g = visible[None].expand(rep, S, L).reshape(rep * S, L)
        scores = torch.matmul(qg, ck.transpose(-1, -2)).float() \
            / math.sqrt(D)
        scores = torch.where(vis_g, scores, torch.tensor(
            -1e30, dtype=torch.float32, device=qh.device))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs.to(qh.dtype), cv)          # [B, Hkv, rS, D]
        return ctx.reshape(B, H, S, D)


class LlamaMLP(nn.Module):
    """SwiGLU (llama.py:216): down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg, device=None):
        super().__init__()
        E, Fd = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _dense(cfg, E, Fd, device)
        self.up_proj = _dense(cfg, E, Fd, device)
        self.down_proj = _dense(cfg, Fd, E, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    """Pre-norm LLaMA block (llama.py:232)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.input_norm = _rms_norm(cfg, device)
        self.attn = LlamaAttention(cfg, device)
        self.post_attn_norm = _rms_norm(cfg, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, cos, sin, cache=None, layer=None):
        x = x + self.attn(self.input_norm(x), cos, sin, cache, layer)
        return x + self.mlp(self.post_attn_norm(x))


class LlamaForCausalLM(JaxTreeBridge, nn.Module):
    """Decoder-only LLaMA LM with its untied ``lm_head`` [V, E], flax's
    parameter names (llama.py:266).

    ``forward(input_ids)`` gives logits in the compute dtype;
    ``forward(input_ids, labels)`` the mean next-token loss, through
    ``chunked_lm_loss`` over the head when ``cfg.loss_chunk > 0``; with a
    ``LlamaKVCache`` (``llama_generate``) the blocks append to it and
    attend over it, RoPE at ``position_offset``. ``cfg.remat`` recomputes
    each block in the backward (``torch.utils.checkpoint``). The
    parameters are made on ``device`` (default ``"meta"``: the engine
    places and initializes them); ``reset_parameters`` draws them from a
    ``torch.Generator`` with the JAX init."""

    def __init__(self, config: LlamaConfig, device="meta"):
        super().__init__()
        cfg = self.config = config
        if cfg.remat_policy is not None:
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported (only "
                f"full block recompute, remat_policy=None) ({ROADMAP_REMAT})")
        if cfg.param_dtype != torch.float32:
            raise NotImplementedError("LlamaForCausalLM keeps fp32 master "
                                      "parameters (param_dtype=float32)")
        V, E = cfg.vocab_size, cfg.hidden_size
        self.embed_tokens = nn.Parameter(torch.empty(
            V, E, dtype=cfg.param_dtype, device=device))
        self.layers = nn.ModuleList(LlamaBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.norm = _rms_norm(cfg, device)
        self.lm_head = nn.Parameter(torch.empty(
            V, E, dtype=cfg.param_dtype, device=device))

    def reset_parameters(self, generator):
        """The JAX init: embed_tokens, lm_head and every projection
        N(0, 0.02), RMSNorm scales 1."""
        with torch.no_grad():
            self.embed_tokens.normal_(0.0, 0.02, generator=generator)
            self.lm_head.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, (Dense, RMSNorm)):
                m.reset_parameters(generator)

    def forward(self, input_ids, labels=None, cache=None, position_offset=0):
        cfg = self.config
        dt = cfg.dtype
        S = input_ids.shape[1]
        x = F.embedding(input_ids, self.embed_tokens).to(dt)
        positions = position_offset + torch.arange(S, device=x.device)
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        for i, block in enumerate(self.layers):
            if cfg.remat and cache is None:
                x = checkpoint(block, x, cos, sin, use_reentrant=False)
            else:
                x = block(x, cos, sin, cache, i)
        if cache is not None:
            cache.index += S
        x = self.norm(x)
        head = self.lm_head.to(dt)
        if labels is not None and cfg.loss_chunk > 0:
            return chunked_lm_loss(x, head, labels, cfg.loss_chunk)
        logits = torch.matmul(x, head.t())
        return logits if labels is None else lm_loss(logits, labels)

    # -- the weight bridge ---------------------------------------------------

    def jax_paths(self, scan_layers=None):
        """{port parameter name: (JAX tree path, layer or None)}: the
        layer of a scan-stacked leaf ``layers/blk/...``, None for a leaf of
        its own (``embed_tokens``, ``layers_3/...``)."""
        scan = self.config.scan_layers if scan_layers is None else scan_layers
        out = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                layer, rest = int(parts[1]), tuple(parts[2:])
                out[name] = (("layers", "blk") + rest, layer) if scan \
                    else ((f"layers_{layer}",) + rest, None)
            else:
                out[name] = (tuple(parts), None)
        return out

    @staticmethod
    def scan_tree(tree):
        return "layers" in tree


@torch.no_grad()
def llama_generate(model, input_ids, max_new_tokens=20, temperature=0.0,
                   generator=None, max_out_tokens=0):
    """KV-cache generation with the training model (llama.py:361): the
    prompt pass fills a ``LlamaKVCache`` of ``max_out_tokens`` positions
    (default ``cfg.max_seq_len``), then one token a step, appended at its
    absolute position, so the cached decode matches a full re-forward.
    Temperature 0 is greedy; otherwise tokens are drawn from
    softmax(logits / temperature) with ``generator``. Returns the prompt
    followed by the new tokens. ``model`` (a ``LlamaForCausalLM``) takes
    the place of JAX's (config, params) pair: it runs where its
    parameters are, in plain PyTorch (JAX computes this path in plain
    ``dot_general``s, outside any Pallas kernel)."""
    cfg = model.config
    dev = model.embed_tokens.device
    ids = torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(
        input_ids) else input_ids).to(dev)
    if max_new_tokens <= 0:
        return ids
    B, S = ids.shape
    max_out = max_out_tokens or cfg.max_seq_len
    if S + max_new_tokens > max_out:
        raise ValueError(f"{S} prompt + {max_new_tokens} new tokens exceed "
                         f"the cache's {max_out} positions")
    cache = LlamaKVCache(cfg, B, max_out, cfg.dtype, dev)
    tok = pick_token(model(ids, cache=cache)[:, -1], temperature, generator)
    new = [tok]
    for step in range(max_new_tokens - 1):
        logits = model(tok[:, None], cache=cache, position_offset=S + step)
        tok = pick_token(logits[:, -1], temperature, generator)
        new.append(tok)
    return torch.cat([ids, torch.stack(new, 1).to(ids.dtype)], dim=1)
