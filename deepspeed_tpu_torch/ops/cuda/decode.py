"""Decode-tick kernels: CUDA (csrc/decode.cu) and their plain versions.

Replaces eleven Pallas kernels of ``deepspeed_tpu/ops/pallas/decode.py``:

- ``ln_qkv_stacked``           ← ``ln_qkv_int8_stacked``    (:432, kernel :496)
- ``matvec_stacked``           ← ``matvec_int8_stacked``    (:523, kernel :558)
- ``out_ffn_stacked``          ← ``out_ffn_int8_stacked``   (:698, kernel :1000)
- ``decode_attention_paged``   ← ``decode_attention_paged`` (:854, kernel :931)
- ``kv_quant_int8``            ← ``kv_quant_int8``          (:297, kernel :279)
- ``decode_attention_stacked`` ← ``decode_attention_int8_stacked`` (:565) and
  ``decode_attention_fp_stacked`` (:794), kernel ``_decode_attn_stacked_kernel``
  (:643)
- ``matvec_int8``, ``ln_qkv_int8``, ``out_ffn_int8``,
  ``decode_attention_int8`` ← the unstacked kernels of the same names
  (:75, :245, :359, :163): one layer's weights ``[in, out]`` and per-tensor
  scales, an ``[B, H, L, D]`` cache. Each is its stacked counterpart at
  one layer: the plain version calls the stacked one with a one-layer
  view, and on CUDA the same device code runs with that view and layer 0.

Layouts follow the JAX functions: weights are layer-stacked ``[L, in,
out]`` and indexed at ``layer`` inside the kernel (on CUDA ``layer`` is
a one-element int32 tensor on the card; the plain versions also take an
int); per-layer vectors are ``[L, n]`` (``[L, 1, n]`` is accepted);
scales are ``[L]`` fp32. A CPU
tensor takes the plain version, which implements every option of the
JAX function; a CUDA tensor launches the kernel or raises. The CUDA
kernels take bf16 activations with norm parameters and biases in fp32:
GPT-2's contract (LayerNorm, biases, gelu_tanh, the fused out-projection,
head dim 64) and LLaMA's (RMSNorm, no biases, SwiGLU with
``fuse_proj=False``, head dim 128, GQA rows), each with bf16 weights or
int8 codes and a bf16 or int8 KV cache, paged, layer-stacked or one
layer's.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.cuda import builder

ROADMAP_DECODE_VARIANTS = ("ROADMAP.md queue 2, item \"decode-kernel "
                           "variants off the served paths\"")
ROADMAP_FP32 = ("ROADMAP.md queue 2, item \"fp32 activations on the "
                "CUDA decode kernels\"")
MAX_SLOTS = 16          # the matvec kernels' register accumulator bound
# the paged-attention kernel's geometry: D/32 lanes per key, groups of
# 1024/D keys inside a page, at most 8 query rows per KV head
ATTN_HEAD_DIMS, PAGE_MULTIPLE, MAX_ROWS = (64, 128), 16, 8
MAX_SMEM = 227 * 1024   # shared memory one block may use on the H100
INT8_HEAD_DIMS = (64, 128)  # the int8 cache's head dims on CUDA
# matvec_int8's activations → the C entry point's act code
ACTS = {None: 0, "gelu_tanh": 1, "gelu": 2}


# ----------------------------------------------------------- plain versions

def _ln(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def _rms(x, w, eps):
    xf = x.float()
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) \
        * w.float()


def _per_layer(a, l):
    """Row ``l`` of a per-layer vector stack [L, n] or [L, 1, n]."""
    return a.reshape(a.shape[0], -1)[l]


def _act(y, act):
    """jax.nn.gelu(approximate=True) for "gelu_tanh", exact for "gelu"."""
    if act == "gelu_tanh":
        return F.gelu(y, approximate="tanh")
    if act == "gelu":
        return F.gelu(y)
    if act is not None:
        raise ValueError(f"act must be None, 'gelu_tanh' or 'gelu', got "
                         f"{act!r}")
    return y


def matvec_stacked_plain(x, w_stack, s, layer, b=None, act=None):
    """act(x[B, K] · w_stack[layer] · s[layer] (+ b[layer])) → [B, N] in
    x's dtype, rounded once (``_matvec_stacked_kernel``; with a bias and
    an activation, ``_matvec_kernel``)."""
    l = int(layer)
    dt = x.dtype
    y = (x.float() @ w_stack[l].to(dt).float()) * s[l].float()
    if b is not None:
        y = y + _per_layer(b, l).float()
    return _act(y, act).to(dt)


def ln_qkv_stacked_plain(x, ln_w, ln_b, w_stack, s, b, layer, eps=1e-5,
                         norm="layer"):
    """norm(x)[B, E] · w_stack[layer] · s[layer] + b[layer] → [B, N] in
    x's dtype. ``norm='rms'`` is bias-free (ln_b and b unused)."""
    l = int(layer)
    dt = x.dtype
    if norm == "rms":
        u = _rms(x, _per_layer(ln_w, l), eps).to(dt)
    else:
        u = _ln(x, _per_layer(ln_w, l), _per_layer(ln_b, l), eps).to(dt)
    y = (u.float() @ w_stack[l].to(dt).float()) * s[l].float()
    if norm != "rms":
        y = y + _per_layer(b, l).float()
    return y.to(dt)


def out_ffn_stacked_plain(ctx, x, wp_stack, sp, bp, ln_w, ln_b, w1_stack,
                          s1, b1, w2_stack, s2, b2, layer, act="gelu_tanh",
                          eps=1e-5, norm="layer", w1b_stack=None, s1b=None,
                          fuse_proj=True):
    """x1 = x + ctx·Wp·sp + bp; u = norm(x1); y = x1 + act(u·W1·s1 + b1)·
    W2·s2 + b2, with x1, u and the activation rounded to x's dtype as
    in ``_out_ffn_stacked_kernel``. ``norm='rms'`` drops ln_b and every
    bias; ``act='swiglu'`` takes the up stack as ``w1b_stack`` (scale
    ``s1b``); ``fuse_proj=False`` takes x as the post-residual x1."""
    l = int(layer)
    dt = x.dtype
    rms = norm == "rms"
    if fuse_proj:
        t = (ctx.float() @ wp_stack[l].to(dt).float()) * sp[l].float()
        if not rms:
            t = t + _per_layer(bp, l).float()
        x1 = x.float() + t
    else:
        x1 = x.float()
    x1r = x1.to(dt)
    if rms:
        u = _rms(x1, _per_layer(ln_w, l), eps).to(dt)
    else:
        u = _ln(x1, _per_layer(ln_w, l), _per_layer(ln_b, l), eps).to(dt)
    h = (u.float() @ w1_stack[l].to(dt).float()) * s1[l].float()
    if not rms:
        h = h + _per_layer(b1, l).float()
    if act == "swiglu":
        up = (u.float() @ w1b_stack[l].to(dt).float()) * s1b[l].float()
        h = F.silu(h) * up
    else:
        h = _act(h, "gelu_tanh" if act == "gelu_tanh" else "gelu")
    acc = h.to(dt).float() @ w2_stack[l].to(dt).float()
    y = x1r.float() + acc * s2[l].float()
    if not rms:
        y = y + _per_layer(b2, l).float()
    return y.to(dt)


# XLA compiles the kv quantizers' ``amax / 127.0`` (decode.py:288,
# adapters.py:66) as amax * fl(1/127): their scales are that product
RCP_127 = float(np.float32(1) / np.float32(127))


def quantize_rows(t):
    """Symmetric int8 codes of every row of t [..., D] over its last axis:
    (codes int8 [..., D], scale fp32 [..., 1]) with sc = max(amax * (1 /
    127), 1e-12) and codes = clip(round(t / sc), -127, 127), an IEEE
    division rounded half to even (``_kv_quant_kernel``; the prompt rows'
    ``_quant_prompt_rows``)."""
    tf = t.float()
    sc = torch.clamp_min(tf.abs().amax(-1, keepdim=True) * RCP_127, 1e-12)
    return torch.clamp(torch.round(tf / sc), -127, 127).to(torch.int8), sc


def fake_quant(t):
    """t rounded through the int8 KV cache's codes: codes * scale, in t's
    dtype (the K/V an int8 cache serves)."""
    codes, sc = quantize_rows(t)
    return (codes.float() * sc).to(t.dtype)


def kv_quant_int8_plain(k, v):
    """Per-(b, h) int8 codes of new K/V rows [B, H, D]: (k codes, k scale
    fp32 [B, H, 1], v codes, v scale); see quantize_rows."""
    return (*quantize_rows(k), *quantize_rows(v))


def _attend(q, k, v, keep, scale, ks=None, vs=None):
    """One slot's S=1 attention over its gathered rows: q [H, R, D], k/v
    [H, K, D] (int8 codes or floats), keep [R, K], scales [H, K] or None.
    The order of operations of ``_decode_attn_paged_kernel``: s = q.k *
    scale (* ks), masked; the sum takes the unscaled p; P.V takes p (* vs)
    rounded to q's dtype. Returns [H, R, D] in q's dtype."""
    s = torch.einsum("hrd,hkd->hrk", q.float(), k.float()) * scale
    if ks is not None:
        s = s * ks.float()[:, None, :]
    s = torch.where(keep[None], s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    d = e.sum(-1, keepdim=True).clamp_min(1e-30)
    if vs is not None:
        e = e * vs.float()[:, None, :]
    ctx = torch.einsum("hrk,hkd->hrd", e.to(q.dtype).float(), v.float()) / d
    return ctx.to(q.dtype)


def decode_attention_paged_plain(q, k_pool, v_pool, pos, page_table, layer,
                                 scale=None, rows_per_step=None,
                                 k_scale=None, v_scale=None):
    """S=1 attention through a paged pool: q [B, H, R, D], pools [Lyr, NB,
    H, page, D] (int8 codes with ``k_scale``/``v_scale`` [Lyr, NB, H, 1,
    page] fp32, or floats), pos [B] (< 0: idle slot, zeros), page_table
    [B, MAXP]. Row j masks keys at k_pos <= pos[b] + j // rows_per_step."""
    B, H, R, D = q.shape
    page = k_pool.shape[3]
    maxp = page_table.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    l = int(layer)
    max_step = 0 if rows_per_step is None else R // rows_per_step - 1
    step = torch.zeros(R, dtype=torch.long, device=q.device) \
        if rows_per_step is None \
        else torch.arange(R, device=q.device) // rows_per_step
    out = torch.zeros_like(q)
    pos_host = pos.tolist()
    for b in range(B):
        p = int(pos_host[b])
        if p < 0:
            continue
        n_live = min(maxp, (p + max_step) // page + 1)
        blocks = page_table[b, :n_live].long()

        def fold(pool):                     # [n, H, page, X] → [H, n*page, X]
            return pool[l, blocks].transpose(0, 1).reshape(
                H, n_live * page, -1)
        kpos = torch.arange(n_live * page, device=q.device)
        keep = kpos[None, :] <= (p + step)[:, None]          # [R, K]
        ks = vs = None
        if k_scale is not None:
            ks = fold(k_scale.transpose(3, 4))[..., 0]
            vs = fold(v_scale.transpose(3, 4))[..., 0]
        out[b] = _attend(q[b], fold(k_pool), fold(v_pool), keep, scale, ks,
                         vs)
    return out


def decode_attention_stacked_plain(q, k_stack, v_stack, pos, layer,
                                   k_scale=None, v_scale=None, scale=None):
    """S=1 attention over a contiguous layer-stacked cache: q [B, H, R, D]
    (R GQA query rows per cache head), caches [Lyr, B, H, L, D] (int8 codes
    with ``k_scale``/``v_scale`` [Lyr, B, H, 1, L] fp32, or floats), one
    position ``pos`` for every row: keys 0..pos attend, the cache's tail
    is never read (``_decode_attn_stacked_kernel``)."""
    B, H, R, D = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    l, n = int(layer), min(int(pos) + 1, k_stack.shape[3])
    keep = torch.ones(R, n, dtype=torch.bool, device=q.device)
    out = torch.empty_like(q)
    for b in range(B):
        ks = vs = None
        if k_scale is not None:
            ks, vs = k_scale[l, b, :, 0, :n], v_scale[l, b, :, 0, :n]
        out[b] = _attend(q[b], k_stack[l, b, :, :n], v_stack[l, b, :, :n],
                         keep, scale, ks, vs)
    return out


def _one(s, device):
    """A per-tensor scale (a number or a one-element tensor) as the [1]
    fp32 stack of one layer."""
    return torch.as_tensor(s, dtype=torch.float32, device=device).reshape(1)


def matvec_int8_plain(x, wq, scale, bias, act=None):
    """act(x[B, E] · wq[E, N] · scale + bias) → [B, N] in x's dtype
    (``_matvec_kernel``, decode.py:63): matvec_stacked_plain at one
    layer."""
    return matvec_stacked_plain(x, wq[None], _one(scale, x.device), 0,
                                bias.reshape(1, -1), act)


def ln_qkv_int8_plain(x, ln_w, ln_b, wq, s, b, eps=1e-5):
    """LayerNorm(x)[B, E] rounded to x's dtype, · wq[E, N] · s + b → [B, N]
    (``_ln_qkv_kernel``, decode.py:225): ln_qkv_stacked_plain at one
    layer."""
    return ln_qkv_stacked_plain(x, ln_w.reshape(1, -1), ln_b.reshape(1, -1),
                                wq[None], _one(s, x.device),
                                b.reshape(1, -1), 0, eps)


def out_ffn_int8_plain(ctx, x, wp, sp, bp, ln_w, ln_b, w1, s1, b1, w2, s2,
                       b2, act="gelu_tanh", eps=1e-5):
    """x1 = x + ctx·wp·sp + bp (fp32 into the LayerNorm, rounded to x's
    dtype for the last residual); y = x1 + act(LN(x1)·w1·s1 + b1)·w2·s2
    + b2, h rounded before w2 (``_out_ffn_kernel``, decode.py:320):
    out_ffn_stacked_plain at one layer."""
    dev = x.device
    return out_ffn_stacked_plain(
        ctx, x, wp[None], _one(sp, dev), bp.reshape(1, -1),
        ln_w.reshape(1, -1), ln_b.reshape(1, -1), w1[None], _one(s1, dev),
        b1.reshape(1, -1), w2[None], _one(s2, dev), b2.reshape(1, -1), 0,
        act, eps)


def decode_attention_int8_plain(q, k_codes, k_scale, v_codes, v_scale, pos,
                                scale=None):
    """S=1 attention of q [B, H, 1, D] over one layer's int8 cache: codes
    [B, H, L, D], scales [B, H, L] fp32, keys 0..pos (``_decode_attn_kernel``,
    decode.py:110): decode_attention_stacked_plain at one layer. Scores
    are q.k · ks · scale, the sum takes the unscaled p, P.V takes p · vs
    rounded to q's dtype; keys past pos (and their scales) are never
    read."""
    return decode_attention_stacked_plain(
        q, k_codes[None], v_codes[None], pos, 0, k_scale[None, :, :, None],
        v_scale[None, :, :, None], scale)


# ---------------------------------------------------------- CUDA wrappers

def _check(fn, name, t, dtype, shape, device, align=16):
    """t on ``device``, of ``dtype`` and ``shape``, contiguous and
    ``align``-byte aligned (16 for what the kernels load in 16-byte
    vectors; a per-layer scale, read as one float, needs 4)."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        if dtype == torch.bfloat16 and t.dtype == torch.float32:
            raise NotImplementedError(
                f"{fn}: the CUDA kernel takes bf16 {name}, got float32 "
                f"({ROADMAP_FP32})")
        raise ValueError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{fn}: {name} must be {align}-byte aligned")


def _split_for(n_tiles, pair=False):
    """The K split of a matvec launch (csrc/decode.cu, split_for): the
    smallest power of two S that puts at least 160 blocks on the card, at
    most 8 blocks a cluster; a paired gate/up launch has two matrices."""
    mats = 2 if pair else 1
    S = 1
    while S * mats < 8 and n_tiles * S * mats < 160:
        S *= 2
    return S


def matvec_smem(B, K, N, prologue, pair=False, wbytes=2):
    """Shared memory of one block of a matvec launch over [K, N] weights
    (csrc/decode.cu, matvec_smem), with the launch's own K split: the fp32
    reduction and partial over a column tile (64 columns of bf16 weights,
    128 of int8: ``wbytes`` 2 or 1), u transposed [kslice, MAXB] bf16 and,
    for a norm prologue, the whole staged input rows and the slice of the
    norm parameters. ``prologue``: "copy" (no norm), "ln_bf16", "ln_f32"
    (fp32 rows) or "rms_bf16"."""
    maxb = 8 if B <= 8 else 16
    cols = 64 if wbytes == 2 else 128
    S = _split_for(-(-N // cols), pair)
    kslice = -(-(-(-K // S)) // 8) * 8
    smem = 9 * maxb * cols * 4 + kslice * maxb * 2
    if prologue == "copy":
        return smem
    row_bytes = 4 if prologue == "ln_f32" else 2
    n_par = 1 if prologue == "rms_bf16" else 2
    return smem + B * K * row_bytes + n_par * kslice * 4


def _check_launches(fn, B, launches, wbytes=2):
    """Refuse a call before launching when one of its matvec launches
    ``(what, K, N, prologue, pair)`` over ``wbytes``-byte weights needs
    more shared memory than a block may have."""
    for what, K, N, prologue, pair in launches:
        need = matvec_smem(B, K, N, prologue, pair, wbytes)
        if need > MAX_SMEM:
            raise ValueError(
                f"{fn}: the {what} launch needs {need} B of shared memory a "
                f"block at B={B} slots, K={K}, N={N} (at most {MAX_SMEM}; "
                f"{ROADMAP_DECODE_VARIANTS})")


def _vec(a, L):
    """[L, n] view of a per-layer vector stack ([L, 1, n] accepted)."""
    return a.reshape(L, -1)


def _scalar_ptr(fn, t, device, name="layer"):
    """Device pointer of a scalar the kernel reads on the card (the layer
    index, a position): a one-element int32 tensor there (no host
    sync)."""
    if not isinstance(t, torch.Tensor) or t.device != device \
            or t.dtype != torch.int32 or t.numel() != 1:
        raise ValueError(f"{fn}: {name} must be a one-element int32 tensor "
                         f"on {device}")
    return t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _weight_dtype(w_stack):
    """The weight type a launch streams: int8 codes or bf16 (both
    contracts take either)."""
    return torch.int8 if w_stack.dtype == torch.int8 else torch.bfloat16


def _scale_ptr(fn, name, s, device):
    """Device pointer of a per-tensor scale: a one-element fp32 tensor on
    the card."""
    if not isinstance(s, torch.Tensor) or s.device != device \
            or s.dtype != torch.float32 or s.numel() != 1:
        raise ValueError(f"{fn}: {name} must be a one-element float32 "
                         f"tensor on {device}")
    return s.data_ptr()


def ln_qkv_stacked(x, ln_w, ln_b, w_stack, s, b, layer, eps=1e-5,
                   norm="layer"):
    """LayerNorm (or RMSNorm) + packed projection over a layer-stacked
    weight (bf16, or int8 codes with ``norm="rms"``); see
    ln_qkv_stacked_plain. ``norm="rms"`` takes no ln_b or b (pass None)."""
    if x.device.type == "cpu":
        return ln_qkv_stacked_plain(x, ln_w, ln_b, w_stack, s, b, layer,
                                    eps, norm)
    fn = "ln_qkv_stacked"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    out = _ln_qkv_launch(fn, x, ln_w, ln_b, w_stack, s, b,
                         _scalar_ptr(fn, layer, x.device), eps, norm)
    builder.launches[fn] += 1
    return out


def _ln_qkv_launch(fn, x, ln_w, ln_b, w_stack, s, b, lp, eps, norm):
    """Check and launch ``dstpu_ln_qkv_stacked`` at layer pointer ``lp``
    (None: layer 0)."""
    if norm not in ("layer", "rms"):
        raise ValueError(f"{fn}: norm must be 'layer' or 'rms', got "
                         f"{norm!r}")
    rms = norm == "rms"
    dev = x.device
    B, E = x.shape
    L, _, N = w_stack.shape
    _check(fn, "s", s, torch.float32, (L,), dev, align=4)
    vecs = [("ln_w", _vec(ln_w, L), (L, E))]
    if not rms:
        vecs += [("ln_b", _vec(ln_b, L), (L, E)), ("b", _vec(b, L), (L, N))]
    wdt = _weight_dtype(w_stack)
    _check(fn, "x", x, torch.bfloat16, (B, E), dev)
    _check(fn, "w_stack", w_stack, wdt, (L, E, N), dev)
    for name, t, shp in vecs:
        _check(fn, name, t, torch.float32, shp, dev)
    if not 1 <= B <= MAX_SLOTS or E % 8 or N % 8:
        raise ValueError(f"{fn}: needs 1 <= B <= {MAX_SLOTS} and E, N "
                         f"multiples of 8, got B={B} E={E} N={N}")
    _check_launches(fn, B, [("projection", E, N,
                             "rms_bf16" if rms else "ln_bf16", False)],
                    w_stack.element_size())
    v = {name: t for name, t, _ in vecs}
    lib = builder.kernels()
    out = torch.empty((B, N), dtype=x.dtype, device=dev)
    lib.call("dstpu_ln_qkv_stacked", x.data_ptr(), v["ln_w"].data_ptr(),
             _ptr(v.get("ln_b")), w_stack.data_ptr(), s.data_ptr(),
             _ptr(v.get("b")), lp, out.data_ptr(), B, E, N, int(rms),
             int(wdt == torch.int8), float(eps), _stream(dev))
    return out


def matvec_stacked(x, w_stack, s, layer):
    """x[B, K] · w_stack[layer] · s[layer] → [B, N], bias-free (LLaMA's
    o-projection; bf16 weights or int8 codes); see matvec_stacked_plain."""
    if x.device.type == "cpu":
        return matvec_stacked_plain(x, w_stack, s, layer)
    fn = "matvec_stacked"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    dev = x.device
    B, K = x.shape
    L, _, N = w_stack.shape
    wdt = _weight_dtype(w_stack)
    _check(fn, "x", x, torch.bfloat16, (B, K), dev)
    _check(fn, "w_stack", w_stack, wdt, (L, K, N), dev)
    _check(fn, "s", s, torch.float32, (L,), dev, align=4)
    if not 1 <= B <= MAX_SLOTS or K % 8 or N % 8:
        raise ValueError(f"{fn}: needs 1 <= B <= {MAX_SLOTS} and K, N "
                         f"multiples of 8, got B={B} K={K} N={N}")
    _check_launches(fn, B, [("projection", K, N, "copy", False)],
                    w_stack.element_size())
    lp = _scalar_ptr(fn, layer, dev)
    lib = builder.kernels()
    out = torch.empty((B, N), dtype=x.dtype, device=dev)
    lib.call("dstpu_matvec_stacked", x.data_ptr(), w_stack.data_ptr(),
             s.data_ptr(), lp, out.data_ptr(), B, K, N,
             int(wdt == torch.int8), _stream(dev))
    builder.launches[fn] += 1
    return out


def out_ffn_stacked(ctx, x, wp_stack, sp, bp, ln_w, ln_b, w1_stack, s1,
                    b1, w2_stack, s2, b2, layer, act="gelu_tanh", eps=1e-5,
                    norm="layer", w1b_stack=None, s1b=None, fuse_proj=True):
    """Attention out-projection + residual + norm + FFN + residual; see
    out_ffn_stacked_plain. On CUDA it takes two contracts: GPT-2's
    (``act="gelu_tanh"``, ``norm="layer"``, ``fuse_proj=True``; three
    launches) and LLaMA's (``act="swiglu"``, ``norm="rms"``,
    ``fuse_proj=False``: x is the post-residual x1 and ctx, wp_stack, sp
    and bp are ignored, as in JAX; two launches; bf16 weights or int8
    codes, all three alike)."""
    if x.device.type == "cpu":
        return out_ffn_stacked_plain(ctx, x, wp_stack, sp, bp, ln_w, ln_b,
                                     w1_stack, s1, b1, w2_stack, s2, b2,
                                     layer, act, eps, norm, w1b_stack, s1b,
                                     fuse_proj)
    fn = "out_ffn_stacked"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if _out_ffn_contract(fn, act, norm, fuse_proj, w1b_stack) == "gpt2":
        out = _out_ffn_gelu_launch(fn, ctx, x, wp_stack, sp, bp, ln_w, ln_b,
                                   w1_stack, s1, b1, w2_stack, s2, b2,
                                   _scalar_ptr(fn, layer, x.device), eps)
        builder.launches[fn] += 1
        return out
    dev = x.device
    B, E = x.shape
    L, _, Fd = w1_stack.shape
    wdt = _weight_dtype(w1_stack)
    _check(fn, "x", x, torch.bfloat16, (B, E), dev)
    _check(fn, "w1_stack", w1_stack, wdt, (L, E, Fd), dev)
    _check(fn, "w2_stack", w2_stack, wdt, (L, Fd, E), dev)
    if not 1 <= B <= MAX_SLOTS or E % 8 or Fd % 8:
        raise ValueError(f"{fn}: needs 1 <= B <= {MAX_SLOTS} and E, F "
                         f"multiples of 8, got B={B} E={E} F={Fd}")
    lp = _scalar_ptr(fn, layer, dev)
    h = torch.empty((B, Fd), dtype=x.dtype, device=dev)
    out = torch.empty((B, E), dtype=x.dtype, device=dev)
    ln_w = _vec(ln_w, L)
    _check(fn, "w1b_stack", w1b_stack, wdt, (L, E, Fd), dev)
    for name, t, shp in (("ln_w", ln_w, (L, E)), ("s1", s1, (L,)),
                         ("s1b", s1b, (L,)), ("s2", s2, (L,))):
        _check(fn, name, t, torch.float32, shp, dev)
    _check_launches(fn, B, [("gate/up", E, Fd, "rms_bf16", True),
                            ("down", Fd, E, "copy", False)],
                    w1_stack.element_size())
    builder.kernels().call(
        "dstpu_out_ffn_glu_stacked", x.data_ptr(), ln_w.data_ptr(),
        w1_stack.data_ptr(), s1.data_ptr(),
        w1b_stack.data_ptr(), s1b.data_ptr(), w2_stack.data_ptr(),
        s2.data_ptr(), lp, h.data_ptr(), out.data_ptr(), B, E, Fd,
        int(wdt == torch.int8), float(eps), _stream(dev))
    builder.launches[fn] += 1
    return out


def _out_ffn_contract(fn, act, norm, fuse_proj, w1b_stack):
    """Which contract an out_ffn call on CUDA takes, "gpt2" or "llama";
    raises NotImplementedError, naming ROADMAP, on any other (exact gelu
    among them)."""
    if (act, norm, fuse_proj) == ("gelu_tanh", "layer", True) \
            and w1b_stack is None:
        return "gpt2"
    if (act, norm, fuse_proj) == ("swiglu", "rms", False) \
            and w1b_stack is not None:
        return "llama"
    raise NotImplementedError(
        f"{fn}: the CUDA kernels take act='gelu_tanh', norm='layer', "
        f"fuse_proj=True or act='swiglu', norm='rms', fuse_proj=False; "
        f"got act={act!r} norm={norm!r} fuse_proj={fuse_proj} "
        f"({ROADMAP_DECODE_VARIANTS})")


def _out_ffn_gelu_launch(fn, ctx, x, wp_stack, sp, bp, ln_w, ln_b, w1_stack,
                         s1, b1, w2_stack, s2, b2, lp, eps):
    """Check and launch GPT-2's out_ffn (``dstpu_out_ffn_stacked``, three
    launches) at layer pointer ``lp`` (None: layer 0)."""
    dev = x.device
    B, E = x.shape
    L, _, Fd = w1_stack.shape
    wdt = _weight_dtype(w1_stack)
    _check(fn, "x", x, torch.bfloat16, (B, E), dev)
    _check(fn, "w1_stack", w1_stack, wdt, (L, E, Fd), dev)
    _check(fn, "w2_stack", w2_stack, wdt, (L, Fd, E), dev)
    if not 1 <= B <= MAX_SLOTS or E % 8 or Fd % 8:
        raise ValueError(f"{fn}: needs 1 <= B <= {MAX_SLOTS} and E, F "
                         f"multiples of 8, got B={B} E={E} F={Fd}")
    scales = {"sp": sp, "s1": s1, "s2": s2}
    for name, t in scales.items():
        _check(fn, name, t, torch.float32, (L,), dev, align=4)
    vecs = {"bp": (_vec(bp, L), (L, E)), "ln_w": (_vec(ln_w, L), (L, E)),
            "ln_b": (_vec(ln_b, L), (L, E)), "b1": (_vec(b1, L), (L, Fd)),
            "b2": (_vec(b2, L), (L, E))}
    _check(fn, "ctx", ctx, torch.bfloat16, (B, E), dev)
    _check(fn, "wp_stack", wp_stack, wdt, (L, E, E), dev)
    for name, (t, shp) in vecs.items():
        _check(fn, name, t, torch.float32, shp, dev)
    _check_launches(fn, B, [("out-projection", E, E, "copy", False),
                            ("up", E, Fd, "ln_f32", False),
                            ("down", Fd, E, "copy", False)],
                    w1_stack.element_size())
    h = torch.empty((B, Fd), dtype=x.dtype, device=dev)
    out = torch.empty((B, E), dtype=x.dtype, device=dev)
    x1 = torch.empty((B, E), dtype=x.dtype, device=dev)
    x1f = torch.empty((B, E), dtype=torch.float32, device=dev)
    v = {**{k: t for k, (t, _) in vecs.items()}, **scales}
    builder.kernels().call(
        "dstpu_out_ffn_stacked", ctx.data_ptr(), x.data_ptr(),
        wp_stack.data_ptr(), v["sp"].data_ptr(), v["bp"].data_ptr(),
        v["ln_w"].data_ptr(), v["ln_b"].data_ptr(), w1_stack.data_ptr(),
        v["s1"].data_ptr(), v["b1"].data_ptr(), w2_stack.data_ptr(),
        v["s2"].data_ptr(), v["b2"].data_ptr(), lp, x1.data_ptr(),
        x1f.data_ptr(), h.data_ptr(), out.data_ptr(), B, E, Fd,
        int(wdt == torch.int8), float(eps), _stream(dev))
    return out


def _check_cache(fn, q, k, v, k_scale, v_scale, shape, sshape, dev):
    """Check a bf16 cache pair, or an int8 one with its fp32 scales, and
    the query for the attention kernel; returns whether it is int8."""
    B, H, R, D = q.shape
    q8 = k_scale is not None
    if (v_scale is not None) != q8:
        raise ValueError(f"{fn}: pass both k_scale and v_scale or neither")
    _check(fn, "q", q, torch.bfloat16, (B, H, R, D), dev)
    for name, t in (("k", k), ("v", v)):
        _check(fn, name, t, torch.int8 if q8 else torch.bfloat16, shape, dev)
    if q8:
        _check(fn, "k_scale", k_scale, torch.float32, sshape, dev)
        _check(fn, "v_scale", v_scale, torch.float32, sshape, dev)
    if D not in (INT8_HEAD_DIMS if q8 else ATTN_HEAD_DIMS):
        raise NotImplementedError(
            f"{fn}: the CUDA kernel takes head dim "
            f"{INT8_HEAD_DIMS if q8 else ATTN_HEAD_DIMS} for a "
            f"{'int8' if q8 else 'bf16'} cache, got {D} "
            f"({ROADMAP_DECODE_VARIANTS})")
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"{fn}: needs 1 <= R <= {MAX_ROWS}, got R={R}")
    return q8


def decode_attention_paged(q, k_pool, v_pool, pos, page_table, layer,
                           k_scale=None, v_scale=None, scale=None,
                           rows_per_step=None):
    """S=1 attention through a paged pool; see
    decode_attention_paged_plain. On CUDA: R <= 8 query rows per KV head
    (GQA or multi-query), head dim 64 or 128 over a bf16 pool or an int8
    one (``k_scale``/``v_scale`` [Lyr, NB, H, 1, page] fp32)."""
    fn = "decode_attention_paged"
    B, H, R, D = q.shape
    if rows_per_step is not None and R % rows_per_step:
        raise ValueError(f"{fn}: R={R} is not a multiple of "
                         f"rows_per_step={rows_per_step}")
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, k_pool, v_pool, pos,
                                            page_table, layer, scale,
                                            rows_per_step, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    dev = q.device
    Lyr, NB, _, page, _ = k_pool.shape
    maxp = page_table.shape[1]
    _check_cache(fn, q, k_pool, v_pool, k_scale, v_scale,
                 (Lyr, NB, H, page, D), (Lyr, NB, H, 1, page), dev)
    _check(fn, "pos", pos, torch.int32, (B,), dev)
    _check(fn, "page_table", page_table, torch.int32, (B, maxp), dev)
    if page % PAGE_MULTIPLE:
        raise ValueError(f"{fn}: page must be a multiple of "
                         f"{PAGE_MULTIPLE}, got {page}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    lp = _scalar_ptr(fn, layer, dev)
    lib = builder.kernels()
    out = torch.empty_like(q)
    lib.call("dstpu_decode_attention", q.data_ptr(), k_pool.data_ptr(),
             v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), pos.data_ptr(),
             page_table.data_ptr(), lp, out.data_ptr(), B, H, R, D, NB,
             page, maxp, int(rows_per_step or 0), 1, scale, _stream(dev))
    builder.launches[fn] += 1
    return out


def decode_attention_stacked(q, k_stack, v_stack, pos, layer, k_scale=None,
                             v_scale=None, scale=None):
    """S=1 attention over a contiguous layer-stacked cache [Lyr, B, H, L,
    D] at one position for every row; see decode_attention_stacked_plain.
    On CUDA: ``pos`` and ``layer`` are one-element int32 tensors on the
    card (the decode loop never syncs to the host), R <= 8, L a multiple
    of 16, head dim 64 or 128 over a bf16 or an int8 cache. The paged
    kernel's body runs it with slot b's keys as one page of L rows in
    block b."""
    fn = "decode_attention_stacked"
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(q, k_stack, v_stack, pos,
                                              layer, k_scale, v_scale, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    out = _stacked_attention_launch(fn, q, k_stack, v_stack, pos,
                                    _scalar_ptr(fn, layer, q.device),
                                    k_scale, v_scale, scale)
    builder.launches[fn] += 1
    return out


def _stacked_attention_launch(fn, q, k_stack, v_stack, pos, lp, k_scale,
                              v_scale, scale):
    """Check and launch ``dstpu_decode_attention`` over a layer-stacked
    cache at layer pointer ``lp`` (None: layer 0)."""
    dev = q.device
    B, H, R, D = q.shape
    Lyr, _, _, L, _ = k_stack.shape
    _check_cache(fn, q, k_stack, v_stack, k_scale, v_scale,
                 (Lyr, B, H, L, D), (Lyr, B, H, 1, L), dev)
    if L % PAGE_MULTIPLE:
        raise ValueError(f"{fn}: the cache length must be a multiple of "
                         f"{PAGE_MULTIPLE}, got {L}")
    pp = _scalar_ptr(fn, pos, dev, "pos")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    lib = builder.kernels()
    out = torch.empty_like(q)
    lib.call("dstpu_decode_attention", q.data_ptr(), k_stack.data_ptr(),
             v_stack.data_ptr(), _ptr(k_scale), _ptr(v_scale), pp, None, lp,
             out.data_ptr(), B, H, R, D, B, L, 1, 0, 0, scale, _stream(dev))
    return out


# ------------------------------------------- the unstacked (one-layer) forms

def _cuda_fn(fn, t):
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {t.device}")
    return t.device


def matvec_int8(x, wq, scale, bias, act=None):
    """act(x[B, E] · wq[E, N] · scale + bias) → [B, N]; see
    matvec_int8_plain. On CUDA: int8 codes ``wq``, ``scale`` a
    one-element fp32 tensor on the card, ``bias`` fp32 [N], ``act`` None,
    "gelu_tanh" or "gelu" (exact), B <= 16."""
    if x.device.type == "cpu":
        return matvec_int8_plain(x, wq, scale, bias, act)
    fn = "matvec_int8"
    dev = _cuda_fn(fn, x)
    if act not in ACTS:
        raise ValueError(f"{fn}: act must be one of {list(ACTS)}, got "
                         f"{act!r}")
    if wq.dtype != torch.int8:
        raise NotImplementedError(
            f"{fn}: the CUDA kernel streams int8 codes, got {wq.dtype} "
            f"weights ({ROADMAP_DECODE_VARIANTS})")
    B, K = x.shape
    N = wq.shape[1]
    _check(fn, "x", x, torch.bfloat16, (B, K), dev)
    _check(fn, "wq", wq, torch.int8, (K, N), dev)
    _check(fn, "bias", bias, torch.float32, (N,), dev)
    sp = _scale_ptr(fn, "scale", scale, dev)
    if not 1 <= B <= MAX_SLOTS or K % 8 or N % 8:
        raise ValueError(f"{fn}: needs 1 <= B <= {MAX_SLOTS} and E, N "
                         f"multiples of 8, got B={B} E={K} N={N}")
    _check_launches(fn, B, [("projection", K, N, "copy", False)], 1)
    out = torch.empty((B, N), dtype=x.dtype, device=dev)
    builder.kernels().call("dstpu_matvec_int8", x.data_ptr(), wq.data_ptr(),
                           sp, bias.data_ptr(), out.data_ptr(), B, K, N,
                           ACTS[act], _stream(dev))
    builder.launches[fn] += 1
    return out


def ln_qkv_int8(x, ln_w, ln_b, wq, s, b, eps=1e-5):
    """LayerNorm + packed projection over one layer's weights wq [E, N]
    (int8 codes or bf16) · s + b; see ln_qkv_int8_plain. On CUDA ``s`` is
    a one-element fp32 tensor on the card."""
    if x.device.type == "cpu":
        return ln_qkv_int8_plain(x, ln_w, ln_b, wq, s, b, eps)
    fn = "ln_qkv_int8"
    dev = _cuda_fn(fn, x)
    _scale_ptr(fn, "s", s, dev)
    out = _ln_qkv_launch(fn, x, ln_w.reshape(1, -1), ln_b.reshape(1, -1),
                         wq[None], s.reshape(1), b.reshape(1, -1), None, eps,
                         "layer")
    builder.launches[fn] += 1
    return out


def out_ffn_int8(ctx, x, wp, sp, bp, ln_w, ln_b, w1, s1, b1, w2, s2, b2,
                 act="gelu_tanh", eps=1e-5):
    """Out-projection + residual + LayerNorm + FFN + residual over one
    layer's weights (int8 codes or bf16) and per-tensor scales; see
    out_ffn_int8_plain. On CUDA: act "gelu_tanh" (three launches), the
    scales one-element fp32 tensors on the card."""
    if x.device.type == "cpu":
        return out_ffn_int8_plain(ctx, x, wp, sp, bp, ln_w, ln_b, w1, s1, b1,
                                  w2, s2, b2, act, eps)
    fn = "out_ffn_int8"
    dev = _cuda_fn(fn, x)
    _out_ffn_contract(fn, act, "layer", True, None)
    for name, t in (("sp", sp), ("s1", s1), ("s2", s2)):
        _scale_ptr(fn, name, t, dev)
    out = _out_ffn_gelu_launch(
        fn, ctx, x, wp[None], sp.reshape(1), bp.reshape(1, -1),
        ln_w.reshape(1, -1), ln_b.reshape(1, -1), w1[None], s1.reshape(1),
        b1.reshape(1, -1), w2[None], s2.reshape(1), b2.reshape(1, -1), None,
        eps)
    builder.launches[fn] += 1
    return out


def decode_attention_int8(q, k_codes, k_scale, v_codes, v_scale, pos,
                          scale=None):
    """S=1 attention of q [B, H, 1, D] over one layer's int8 cache (codes
    [B, H, L, D], scales [B, H, L] fp32) at keys 0..pos; see
    decode_attention_int8_plain. On CUDA ``pos`` is a one-element int32
    tensor on the card, L a multiple of 16, head dim 64 or 128; blocks
    past pos are not read."""
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k_codes, k_scale, v_codes,
                                           v_scale, pos, scale)
    fn = "decode_attention_int8"
    dev = _cuda_fn(fn, q)
    B, H, S, D = q.shape
    L = k_codes.shape[2]
    if S != 1:
        raise ValueError(f"{fn}: the decode kernel takes S=1, got S={S}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(fn, name, t, torch.float32, (B, H, L), dev)
    out = _stacked_attention_launch(
        fn, q, k_codes[None], v_codes[None], pos, None,
        k_scale.view(1, B, H, 1, L), v_scale.view(1, B, H, 1, L), scale)
    builder.launches[fn] += 1
    return out


def _rows_view(fn, t, B, H, D, dev):
    """The batch stride of a [B, H, D] bf16 row tensor whose heads and dims
    are contiguous (a column slice of the packed qkv output is)."""
    if t.device != dev or t.dtype != torch.bfloat16 \
            or tuple(t.shape) != (B, H, D) or t.stride()[1:] != (D, 1) \
            or t.data_ptr() % 16 or t.stride(0) % 8:
        raise ValueError(f"{fn}: new rows must be bf16 [{B}, {H}, {D}] on "
                         f"{dev} with contiguous heads, 16-byte aligned")
    return t.stride(0)


def kv_quant_int8(k, v, out=None, layer=None, blocks=None, rows=None):
    """int8 codes and fp32 scales of the new K/V rows k, v [B, H, D]; see
    kv_quant_int8_plain.

    With ``out=None`` returns (k codes, k scale [B, H, 1], v codes, v
    scale), the JAX function's signature. With ``out = (k codes, k scale,
    v codes, v scale)`` of a cache, writes them in place at layer
    ``layer`` (None: 0) and returns ``out``:

    - the paged pool ([Lyr, NB, H, page, D] codes, [Lyr, NB, H, 1, page]
      scales): slot b's row goes to block ``blocks[b]``, row ``rows[b]``;
    - the layer-stacked cache ([Lyr, B, H, L, D], [Lyr, B, H, 1, L]):
      ``blocks=None``, and ``rows`` is the one position of every slot.

    On CUDA ``layer``, ``blocks`` and ``rows`` are int32 tensors on the
    card (``layer`` and a stacked ``rows`` of one element)."""
    fn = "kv_quant_int8"
    if k.device.type == "cpu":
        codes = kv_quant_int8_plain(k, v)
        if out is None:
            return codes
        l = 0 if layer is None else int(layer)
        b = torch.arange(k.shape[0]) if blocks is None else blocks.long()
        r = rows.long().reshape(-1).expand(k.shape[0])
        kq, ksc, vq, vsc = codes
        for dst, val in zip(out, (kq, ksc[..., 0], vq, vsc[..., 0])):
            if val.dim() == 3:
                dst[l][b, :, r] = val
            else:
                dst[l][b, :, 0, r] = val
        return out
    if k.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {k.device}")
    dev = k.device
    B, H, D = k.shape
    if D not in ATTN_HEAD_DIMS:
        raise NotImplementedError(
            f"{fn}: the CUDA kernel takes head dim {ATTN_HEAD_DIMS}, got {D} "
            f"({ROADMAP_DECODE_VARIANTS})")
    k_stride = _rows_view(fn, k, B, H, D, dev)
    v_stride = _rows_view(fn, v, B, H, D, dev)
    if out is None:
        out = (torch.empty((B, H, D), dtype=torch.int8, device=dev),
               torch.empty((B, H, 1), dtype=torch.float32, device=dev),
               torch.empty((B, H, D), dtype=torch.int8, device=dev),
               torch.empty((B, H, 1), dtype=torch.float32, device=dev))
        NB, L, lp, bp, rp, r_stride = B, 1, None, None, None, 0
    else:
        Lyr, NB, _, L, _ = out[0].shape
        for name, t, dt, shp in (
                ("k codes", out[0], torch.int8, (Lyr, NB, H, L, D)),
                ("k scale", out[1], torch.float32, (Lyr, NB, H, 1, L)),
                ("v codes", out[2], torch.int8, (Lyr, NB, H, L, D)),
                ("v scale", out[3], torch.float32, (Lyr, NB, H, 1, L))):
            _check(fn, name, t, dt, shp, dev)
        lp = None if layer is None else _scalar_ptr(fn, layer, dev)
        if blocks is None:
            if NB != B:
                raise ValueError(f"{fn}: a stacked cache holds {NB} slots, "
                                 f"the rows {B}")
            rp, r_stride, bp = _scalar_ptr(fn, rows, dev, "rows"), 0, None
        else:
            _check(fn, "blocks", blocks, torch.int32, (B,), dev)
            _check(fn, "rows", rows, torch.int32, (B,), dev)
            rp, r_stride, bp = rows.data_ptr(), 1, blocks.data_ptr()
    builder.kernels().call(
        "dstpu_kv_quant_int8", k.data_ptr(), v.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(), lp, bp, rp,
        B, H, D, k_stride, v_stride, NB, L, r_stride, _stream(dev))
    builder.launches[fn] += 1
    return out
