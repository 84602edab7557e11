"""GPT-2 and LLaMA adapters for the continuous-batching serving engine.

Port of ``deepspeed_tpu/serving/adapters.py`` (both families: bf16/fp32
weights or int8 weight codes, a bf16/fp32 pool or an int8 one; prefix
sharing, ``verify`` and ``prefill_suffix`` are not ported). Two kinds of
device work per engine:

- ``tick``: decode steps over the whole slot set — per-slot positions,
  paged-attention reads through the page table, idle slots masked by
  ``pos[b] < 0``. Each layer runs the decode kernels
  (``ln_qkv_stacked``, ``decode_attention_paged``, ``out_ffn_stacked``,
  and for a large LLaMA ``matvec_stacked``); the new K/V rows are
  appended into the pool in place (row ``pos[b] % page`` of block
  ``page_table[b, pos[b] // page]``), into an int8 pool by
  ``kv_quant_int8``.
- ``prefill``: one request's prompt pass at a pow2-bucketed padded
  length through the flash kernel, writing K/V (pad rows included)
  straight into the slot's pages and returning last-position logits.

PyTorch runs eagerly, so there are no compiled programs to cache: the
layer and step loops are Python loops over kernel launches, and nothing
syncs to the host inside a tick except the sampling of a request that
asked for a temperature.
"""

import math

import numpy as np
import torch

from deepspeed_tpu_torch.models import gpt2_inference, llama_inference
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.models.gpt2_inference import (block_forward,
                                                       layer_norm)
from deepspeed_tpu_torch.models.llama import (LlamaConfig, rms_norm,
                                              rope_angles, rope_rows,
                                              rope_tables)
from deepspeed_tpu_torch.ops.attention import dot_product_attention
from deepspeed_tpu_torch.ops.cuda.decode import (decode_attention_paged,
                                                 kv_quant_int8,
                                                 ln_qkv_stacked,
                                                 matvec_stacked,
                                                 out_ffn_stacked,
                                                 quantize_rows)
from deepspeed_tpu_torch.serving.paged_cache import (PagedCacheSpec,
                                                     PagedKVCache)


# ----------------------------------------------------------- pool writes

def _append_rows(pool, l, lid, blk_ids, rows, k3, v3):
    """Write one new K/V row per slot ([B, H, D]) into layer ``l`` (device
    index ``lid``) of the pool at (block blk_ids[b], row rows[b]), in
    place; into an int8 pool as kv_quant_int8's codes and scales. Idle
    slots arrive pointed at the trash block, so the write is always
    legal."""
    if len(pool) == 4:
        kv_quant_int8(k3, v3, out=pool, layer=lid, blocks=blk_ids, rows=rows)
        return
    kc, vc = pool
    kc[l][blk_ids, :, rows] = k3.to(kc.dtype)
    vc[l][blk_ids, :, rows] = v3.to(vc.dtype)


def _write_prompt_pages(pool, l, k, v, pages, page):
    """Blockify one layer's prompt K/V ([H, Sp, D], Sp = len(pages)*page)
    and write the blocks into the pool at ``pages``, in place; into an
    int8 pool as per-(head, position) codes and scales
    (``_quant_prompt_rows``). Page-table tails past the slot's allocation
    arrive as the trash block; duplicate trash writes are harmless by
    construction."""
    H, Sp, D = k.shape
    npg = pages.shape[0]
    assert npg * page == Sp, (Sp, npg, page)

    def to_blocks(t):                       # → [npg, H, page, X]
        return t.reshape(H, npg, page, -1).transpose(0, 1)
    if len(pool) == 4:
        for t, codes, scales in ((k, pool[0], pool[1]),
                                 (v, pool[2], pool[3])):
            c, sc = quantize_rows(t)
            codes[l][pages] = to_blocks(c)
            scales[l][pages] = to_blocks(sc).transpose(2, 3)
        return
    kc, vc = pool
    kc[l][pages] = to_blocks(k).to(kc.dtype)
    vc[l][pages] = to_blocks(v).to(vc.dtype)


def _gather_blocks(pt, pos, page):
    """(block ids, row offsets) [B] int32 for appending each slot's next
    row. Idle slots (pos < 0) resolve inside their all-trash table
    rows."""
    maxp = pt.shape[1]
    idx = torch.clamp(torch.div(pos, page, rounding_mode="floor"),
                      0, maxp - 1).long()
    blk_ids = pt.gather(1, idx[:, None])[:, 0].int()
    rows = torch.remainder(pos, page).int()
    return blk_ids, rows


# --------------------------------------------------------------- sampling

def _sample_generator(seed, idx, device):
    """Per-(request, token index) generator: the sampling key depends
    only on the request's ``sample_key`` and the token's global index,
    never on engine state. It cannot reproduce jax.random's bits: the
    JAX engine and the port sample different tokens from one seed."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xffffffff) << 32) | (int(idx) & 0xffffffff))
    return g


def _pick_next(logits, seeds, idxs, temps):
    """Greedy argmax per slot; slots with temperature > 0 sample from
    softmax(logits / t) with their own generator. Returns (tokens [B]
    int64 on the logits' device, logits fp32)."""
    logits32 = logits.float()
    nxt = torch.argmax(logits32, dim=-1)
    for b in np.nonzero(np.asarray(temps) > 0)[0]:
        probs = torch.softmax(logits32[b] / max(float(temps[b]), 1e-6), -1)
        g = _sample_generator(seeds[b], idxs[b], logits32.device)
        nxt[b] = torch.multinomial(probs, 1, generator=g)[0]
    return nxt, logits32


def sample_token(logits32, seed, idx, temperature):
    """One-row invocation of the tick's sampling rule: the host-side
    prefill pick for a sampled request."""
    logits32 = torch.as_tensor(logits32, dtype=torch.float32)
    tok, _ = _pick_next(logits32[None], [seed], [idx], [temperature])
    return int(tok[0])


# ---------------------------------------------------------------- adapters

class _PagedAdapter:
    """What both families' adapters share: the config, weights and pool
    geometry, the device, and the per-layer indices the kernels read."""

    def __init__(self, cfg, params, spec: PagedCacheSpec, device,
                 n_layers, kv_heads):
        assert (spec.n_layers, spec.kv_heads, spec.head_dim) == \
            (n_layers, kv_heads, cfg.head_dim)
        self.cfg, self.spec, self.p = cfg, spec, params
        self.device = torch.device(device)
        # per-layer indices live on the device: a kernel reads its layer
        # there, so the layer loop never syncs to the host
        self._layer_ids = torch.arange(n_layers, dtype=torch.int32,
                                       device=self.device)

    def make_cache(self) -> PagedKVCache:
        return PagedKVCache(self.spec, self.device)

    def _as(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)


class GPT2ServingAdapter(_PagedAdapter):
    """Paged serving over the port's stacked GPT-2 weights (see
    ``models/gpt2_inference.as_serving_params``): bf16/fp32 or int8 codes
    with one scale a layer, a bf16/fp32 or (``kv_cache_bits=8``) int8
    pool. ``quantize_bits=8`` quantizes fp weights when the adapter is
    built (``serving/adapters.py:251-255``)."""

    def __init__(self, cfg: GPT2Config, params, spec: PagedCacheSpec,
                 device, quantize_bits=0):
        if not cfg.tie_word_embeddings or cfg.n_embd % cfg.n_head:
            raise ValueError("paged GPT-2 serving needs the tied-embedding "
                             "LM head and n_embd a multiple of n_head")
        if quantize_bits == 8 and not gpt2_inference.is_int8(params):
            params = gpt2_inference.quantize_gpt2_inference_params(params)
        super().__init__(cfg, params, spec, device, cfg.n_layer, cfg.n_head)
        # ((stack, [L] scales) of qkv, o-projection, up, down): bf16/fp32
        # stacks run with scale 1, as in JAX
        self._w = gpt2_inference.weight_stacks(params)

    def max_prompt_len(self):
        return self.cfg.n_positions

    def tick(self, pool, toks, pos, pt, seeds, idxs, temps, steps=1):
        """Run ``steps`` decode steps. ``toks``/``pos`` [B] and ``pt``
        [B, MAXP] are host arrays; ``seeds``/``idxs``/``temps`` [B] drive
        per-slot sampling (global token index of each slot's NEXT token).
        Updates ``pool`` in place and returns (pool, tokens [steps, B],
        last-step logits [B, V] fp32)."""
        cfg, p = self.cfg, self.p
        toks = self._as(toks, torch.long)
        pos = self._as(pos, torch.int32)
        pt = self._as(pt, torch.int32)
        idxs = np.asarray(idxs)
        kc, vc = pool[0], pool[len(pool) // 2]        # (k, [ks,] v, [vs])
        scales = {"k_scale": pool[1], "v_scale": pool[3]} \
            if len(pool) == 4 else {}
        scale = 1.0 / math.sqrt(cfg.head_dim)

        def attend(l, lid, qh, k3, v3):     # at this step's blk_ids, rows, pos
            _append_rows(pool, l, lid, blk_ids, rows, k3, v3)
            return decode_attention_paged(qh, kc, vc, pos, pt, lid,
                                          scale=scale, **scales)
        out, logits32 = [], None
        for t in range(steps):
            x = p["wte"][toks] + p["wpe"][pos.clamp(0, cfg.n_positions - 1)
                                          .long()]
            blk_ids, rows = _gather_blocks(pt, pos, self.spec.page_size)
            for l in range(cfg.n_layer):
                x = gpt2_inference.decode_layer(p, cfg, self._w, x, l,
                                                self._layer_ids[l], attend)
            u = layer_norm(x, p["ln_f_w"], p["ln_f_b"], cfg.layer_norm_epsilon)
            logits = u @ p["wte"].T
            toks, logits32 = _pick_next(logits, seeds, idxs + t, temps)
            out.append(toks)
            pos = pos + 1
        return pool, torch.stack(out), logits32

    def prefill(self, pool, ids, length, pages):
        """Prompt pass over ids [1, Sp] (Sp = len(pages) * page, zero
        padded past ``length``): writes every row of the bucket, pad rows
        included, into ``pages`` and returns (pool, fp32 logits [V] at
        position length - 1). int8 codes are dequantized one layer at a
        time (the prefill's ``deq``)."""
        cfg, p = self.cfg, self.p
        ids = self._as(ids, torch.long)
        pages = self._as(pages, torch.long)
        Sp = ids.shape[1]
        assert Sp <= cfg.n_positions, (
            f"prefill bucket {Sp} exceeds n_positions {cfg.n_positions}")
        x = p["wte"][ids] + p["wpe"][:Sp][None]
        for l in range(cfg.n_layer):
            x, k, v = block_forward(p, cfg, l, x, dot_product_attention)
            _write_prompt_pages(pool, l, k[0], v[0], pages,
                                self.spec.page_size)
        u = layer_norm(x[0, int(length) - 1], p["ln_f_w"], p["ln_f_b"],
                       cfg.layer_norm_epsilon)
        return pool, (u @ p["wte"].T).float()


# ------------------------------------------------------------------ LLaMA



class LlamaServingAdapter(_PagedAdapter):
    """Paged serving over the port's packed LLaMA weights (see
    ``models/llama_inference``): bf16/fp32 or int8 codes, a bf16/fp32 or
    (``kv_cache_bits=8``) int8 pool. GQA: the pool holds Hkv heads and the
    paged attention kernel takes rep = H/Hkv query rows per KV head.
    ``quantize_bits=8`` quantizes fp weights when the adapter is built
    (``serving/adapters.py:715-719``)."""

    def __init__(self, cfg: LlamaConfig, params, spec: PagedCacheSpec,
                 device, quantize_bits=0):
        if cfg.n_heads % cfg.kv_heads:
            raise ValueError(f"{cfg.n_heads} heads are not a multiple of "
                             f"{cfg.kv_heads} KV heads")
        if quantize_bits == 8 and not llama_inference.is_int8(params):
            params = llama_inference.quantize_serving_params(params)
        super().__init__(cfg, params, spec, device, cfg.n_layers,
                         cfg.kv_heads)
        self._w = {name: llama_inference._weights(params, name, cfg.n_layers)
                   for name in ("qkv_w", "o_w", "gate_w", "up_w", "down_w")}

    def max_prompt_len(self):
        return self.cfg.max_seq_len

    def fused_proj(self):
        """True when the o-projection fuses into out_ffn_stacked."""
        return llama_inference.fused_proj(self.cfg, self.p["o_w"])

    def tick(self, pool, toks, pos, pt, seeds, idxs, temps, steps=1):
        """Run ``steps`` decode steps; see GPT2ServingAdapter.tick."""
        cfg, p = self.cfg, self.p
        E, H, Hkv, D = (cfg.hidden_size, cfg.n_heads, cfg.kv_heads,
                        cfg.head_dim)
        rep, eps = H // Hkv, cfg.rms_eps
        (Wq, sq), (Wo, so), (Wg, sg), (Wu, su), (Wd, sd) = (
            self._w[k] for k in ("qkv_w", "o_w", "gate_w", "up_w", "down_w"))
        fused = self.fused_proj()
        toks = self._as(toks, torch.long)
        pos = self._as(pos, torch.int32)
        pt = self._as(pt, torch.int32)
        idxs = np.asarray(idxs)
        kc, vc = pool[0], pool[len(pool) // 2]        # (k, [ks,] v, [vs])
        scales = {"k_scale": pool[1], "v_scale": pool[3]} \
            if len(pool) == 4 else {}
        B = toks.shape[0]
        out, logits32 = [], None
        for t in range(steps):
            x = p["embed"][toks]
            blk_ids, rows = _gather_blocks(pt, pos, self.spec.page_size)
            cos, sin = rope_tables(pos, D, cfg.rope_theta, x.dtype)
            for l in range(cfg.n_layers):
                lid = self._layer_ids[l]
                qkv = ln_qkv_stacked(x, p["norm1"], None, Wq, sq, None, lid,
                                     eps=eps, norm="rms")
                qk = rope_rows(qkv[:, :(H + Hkv) * D].reshape(B, H + Hkv, D),
                               cos, sin)
                v3 = qkv[:, (H + Hkv) * D:].reshape(B, Hkv, D)
                _append_rows(pool, l, lid, blk_ids, rows, qk[:, H:], v3)
                ctx = decode_attention_paged(
                    qk[:, :H].reshape(B, Hkv, rep, D).contiguous(), kc, vc,
                    pos, pt, lid, scale=1.0 / math.sqrt(D),
                    **scales).reshape(B, H * D)
                if fused:
                    x = out_ffn_stacked(
                        ctx, x, Wo, so, None, p["norm2"], None, Wg, sg, None,
                        Wd, sd, None, lid, act="swiglu", eps=eps,
                        norm="rms", w1b_stack=Wu, s1b=su)
                else:
                    x1 = x + matvec_stacked(ctx, Wo, so, lid)
                    x = out_ffn_stacked(
                        None, x1, None, None, None, p["norm2"], None, Wg, sg,
                        None, Wd, sd, None, lid, act="swiglu", eps=eps,
                        norm="rms", w1b_stack=Wu, s1b=su, fuse_proj=False)
            u = rms_norm(x, p["norm_scale"], eps)
            logits = u @ p["head"].T
            toks, logits32 = _pick_next(logits, seeds, idxs + t, temps)
            out.append(toks)
            pos = pos + 1
        return pool, torch.stack(out), logits32

    def prefill(self, pool, ids, length, pages):
        """Prompt pass over ids [1, Sp]; see GPT2ServingAdapter.prefill.
        The projections and the LM head are plain products on each
        layer's dequantized weights (JAX leaves them to XLA); attention is
        the flash kernel, GQA K/V unrepeated."""
        cfg, p = self.cfg, self.p
        ids = self._as(ids, torch.long)
        pages = self._as(pages, torch.long)
        Sp = ids.shape[1]
        cos, sin = rope_angles(torch.arange(Sp, device=self.device),
                               cfg.head_dim, cfg.rope_theta)
        x = p["embed"][ids]
        for l in range(cfg.n_layers):
            x, k, v = llama_inference.block_forward(
                llama_inference.layer_weights(p, l), cfg, x, cos, sin,
                dot_product_attention)
            _write_prompt_pages(pool, l, k[0], v[0], pages,
                                self.spec.page_size)
        u = rms_norm(x[0, int(length) - 1], p["norm_scale"], cfg.rms_eps)
        return pool, (u @ p["head"].T).float()
