"""GPT-2 adapter for the continuous-batching serving engine.

Port of ``deepspeed_tpu/serving/adapters.py`` (fp pool, bf16/fp32
weights). Two kinds of device work per engine:

- ``tick``: decode steps over the whole slot set — per-slot positions,
  paged-attention reads through the page table, idle slots masked by
  ``pos[b] < 0``. Each layer runs the three decode kernels
  (``ln_qkv_stacked``, ``decode_attention_paged``, ``out_ffn_stacked``);
  the new K/V rows are appended into the pool in place (row
  ``pos[b] % page`` of block ``page_table[b, pos[b] // page]``).
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

from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.models.gpt2_inference import (block_forward,
                                                       layer_norm)
from deepspeed_tpu_torch.ops.attention import dot_product_attention
from deepspeed_tpu_torch.ops.cuda.decode import (decode_attention_paged,
                                                 ln_qkv_stacked,
                                                 out_ffn_stacked)
from deepspeed_tpu_torch.serving.paged_cache import (PagedCacheSpec,
                                                     PagedKVCache)


# ----------------------------------------------------------- pool writes

def _append_rows(pool, l, blk_ids, rows, k3, v3):
    """Write one new K/V row per slot ([B, H, D]) into layer ``l`` of the
    pool at (block blk_ids[b], row rows[b]), in place. Idle slots arrive
    pointed at the trash block, so the write is always legal."""
    kc, vc = pool
    kc[l][blk_ids, :, rows] = k3.to(kc.dtype)
    vc[l][blk_ids, :, rows] = v3.to(vc.dtype)


def _write_prompt_pages(pool, l, k, v, pages, page):
    """Blockify one layer's prompt K/V ([H, Sp, D], Sp = len(pages)*page)
    and write the blocks into the pool at ``pages``, in place. Page-table
    tails past the slot's allocation arrive as the trash block; duplicate
    trash writes are harmless by construction."""
    H, Sp, D = k.shape
    npg = pages.shape[0]
    assert npg * page == Sp, (Sp, npg, page)
    kc, vc = pool

    def to_blocks(t):                       # → [npg, H, page, D]
        return t.reshape(H, npg, page, D).transpose(0, 1)
    kc[l][pages] = to_blocks(k).to(kc.dtype)
    vc[l][pages] = to_blocks(v).to(vc.dtype)


def _gather_blocks(pt, pos, page):
    """(block ids, row offsets) for appending each slot's next row. Idle
    slots (pos < 0) resolve inside their all-trash table rows."""
    maxp = pt.shape[1]
    idx = torch.clamp(torch.div(pos, page, rounding_mode="floor"),
                      0, maxp - 1).long()
    blk_ids = pt.gather(1, idx[:, None])[:, 0].long()
    rows = torch.remainder(pos, page).long()
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


# ------------------------------------------------------------------ GPT-2

class GPT2ServingAdapter:
    """Paged serving over the port's stacked GPT-2 weights (see
    ``models/gpt2_inference.as_serving_params``)."""

    def __init__(self, cfg: GPT2Config, params, spec: PagedCacheSpec,
                 device):
        if not cfg.tie_word_embeddings or cfg.n_embd % cfg.n_head:
            raise ValueError("paged GPT-2 serving needs the tied-embedding "
                             "LM head and n_embd a multiple of n_head")
        assert spec.n_layers == cfg.n_layer
        assert spec.kv_heads == cfg.n_head
        assert spec.head_dim == cfg.head_dim
        self.cfg, self.spec, self.p = cfg, spec, params
        self.device = torch.device(device)
        L = cfg.n_layer
        # bf16/fp32 stacks run the weight kernels with scale 1, as JAX does
        self._ones = torch.ones(L, dtype=torch.float32, device=self.device)
        # per-layer indices live on the device: a kernel reads its layer
        # there, so the layer loop never syncs to the host
        self._layer_ids = torch.arange(L, dtype=torch.int32,
                                       device=self.device)

    def make_cache(self) -> PagedKVCache:
        return PagedKVCache(self.spec, self.device)

    def max_prompt_len(self):
        return self.cfg.n_positions

    def _as(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def tick(self, pool, toks, pos, pt, seeds, idxs, temps, steps=1):
        """Run ``steps`` decode steps. ``toks``/``pos`` [B] and ``pt``
        [B, MAXP] are host arrays; ``seeds``/``idxs``/``temps`` [B] drive
        per-slot sampling (global token index of each slot's NEXT token).
        Updates ``pool`` in place and returns (pool, tokens [steps, B],
        last-step logits [B, V] fp32)."""
        cfg, p = self.cfg, self.p
        E, H, D = cfg.n_embd, cfg.n_head, cfg.head_dim
        eps = cfg.layer_norm_epsilon
        toks = self._as(toks, torch.long)
        pos = self._as(pos, torch.int32)
        pt = self._as(pt, torch.int32)
        idxs = np.asarray(idxs)
        ones = self._ones
        kc, vc = pool
        B = toks.shape[0]
        out, logits32 = [], None
        for t in range(steps):
            x = p["wte"][toks] + p["wpe"][pos.clamp(0, cfg.n_positions - 1)
                                          .long()]
            blk_ids, rows = _gather_blocks(pt, pos, self.spec.page_size)
            for l in range(cfg.n_layer):
                lid = self._layer_ids[l]
                qkv = ln_qkv_stacked(x, p["ln1_w"], p["ln1_b"],
                                     p["attn_qkvw"], ones, p["attn_qkvb"],
                                     lid, eps=eps)
                qh = qkv[:, :E].reshape(B, H, 1, D).contiguous()
                k3 = qkv[:, E:2 * E].reshape(B, H, D)
                v3 = qkv[:, 2 * E:].reshape(B, H, D)
                _append_rows(pool, l, blk_ids, rows, k3, v3)
                ctx = decode_attention_paged(qh, kc, vc, pos, pt, lid,
                                             scale=1.0 / math.sqrt(D))
                x = out_ffn_stacked(
                    ctx.reshape(B, E), x, p["attn_ow"], ones, p["attn_ob"],
                    p["ln2_w"], p["ln2_b"], p["inter_w"], ones,
                    p["inter_b"], p["output_w"], ones, p["output_b"], lid,
                    act="gelu_tanh", eps=eps)
            u = layer_norm(x, p["ln_f_w"], p["ln_f_b"], eps)
            logits = u @ p["wte"].T
            toks, logits32 = _pick_next(logits, seeds, idxs + t, temps)
            out.append(toks)
            pos = pos + 1
        return pool, torch.stack(out), logits32

    def prefill(self, pool, ids, length, pages):
        """Prompt pass over ids [1, Sp] (Sp = len(pages) * page, zero
        padded past ``length``): writes every row of the bucket, pad rows
        included, into ``pages`` and returns (pool, fp32 logits [V] at
        position length - 1)."""
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
