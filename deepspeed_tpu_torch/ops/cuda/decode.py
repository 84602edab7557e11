"""Decode-tick kernels: CUDA (csrc/decode.cu) and their plain versions.

Replaces four Pallas kernels of ``deepspeed_tpu/ops/pallas/decode.py``:

- ``ln_qkv_stacked``         ← ``ln_qkv_int8_stacked``    (:432, kernel :496)
- ``matvec_stacked``         ← ``matvec_int8_stacked``    (:523, kernel :558)
- ``out_ffn_stacked``        ← ``out_ffn_int8_stacked``   (:698, kernel :1000)
- ``decode_attention_paged`` ← ``decode_attention_paged`` (:854, kernel :931)

Layouts follow the JAX functions: weights are layer-stacked ``[L, in,
out]`` and indexed at ``layer`` inside the kernel (on CUDA ``layer`` is
a one-element int32 tensor on the card; the plain versions also take an
int); per-layer vectors are ``[L, n]`` (``[L, 1, n]`` is accepted);
scales are ``[L]`` fp32. A CPU
tensor takes the plain version, which implements every option of the
JAX function; a CUDA tensor launches the kernel or raises. The CUDA
kernels take bf16 activations and weights with norm parameters and biases
in fp32, and the fp paged pool: GPT-2's contract (LayerNorm, biases,
gelu_tanh, the fused out-projection) and LLaMA's (RMSNorm, no biases,
SwiGLU with ``fuse_proj=False``, head dim 128, GQA rows).
"""

import math

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.config.config import ROADMAP_INT8
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


def matvec_stacked_plain(x, w_stack, s, layer):
    """x[B, K] · w_stack[layer] · s[layer] → [B, N] in x's dtype, bias-free
    (``_matvec_stacked_kernel``)."""
    l = int(layer)
    dt = x.dtype
    y = (x.float() @ w_stack[l].to(dt).float()) * s[l].float()
    return y.to(dt)


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
    elif act == "gelu_tanh":
        h = F.gelu(h, approximate="tanh")
    else:
        h = F.gelu(h)
    acc = h.to(dt).float() @ w2_stack[l].to(dt).float()
    y = x1r.float() + acc * s2[l].float()
    if not rms:
        y = y + _per_layer(b2, l).float()
    return y.to(dt)


def decode_attention_paged_plain(q, k_pool, v_pool, pos, page_table, layer,
                                 scale=None, rows_per_step=None):
    """S=1 attention through a paged pool: q [B, H, R, D], pools [Lyr, NB,
    H, page, D], pos [B] (< 0: idle slot, zeros), page_table [B, MAXP].
    Row j masks keys at k_pos <= pos[b] + j // rows_per_step."""
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

        def fold(pool):                     # [n, H, page, D] → [H, n*page, D]
            return pool[l, blocks].transpose(0, 1).reshape(
                H, n_live * page, D).float()
        k, v = fold(k_pool), fold(v_pool)
        s = torch.einsum("hrd,hkd->hrk", q[b].float(), k) * scale
        kpos = torch.arange(n_live * page, device=q.device)
        keep = kpos[None, :] <= (p + step)[:, None]          # [R, K]
        s = torch.where(keep[None], s, torch.full_like(s, -1e30))
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        d = e.sum(-1, keepdim=True).clamp_min(1e-30)
        ctx = torch.einsum("hrk,hkd->hrd", e.to(q.dtype).float(), v) / d
        out[b] = ctx.to(q.dtype)
    return out


# ---------------------------------------------------------- CUDA wrappers

def _check(fn, name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        if dtype == torch.bfloat16 and t.dtype == torch.int8:
            raise NotImplementedError(
                f"{fn}: int8 {name} is not ported ({ROADMAP_INT8})")
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
    if t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def _split_for(n_tiles, pair=False):
    """The K split of a matvec launch (csrc/decode.cu, split_for): the
    smallest power of two S that puts at least 160 blocks on the card, at
    most 8 blocks a cluster; a paired gate/up launch has two matrices."""
    mats = 2 if pair else 1
    S = 1
    while S * mats < 8 and n_tiles * S * mats < 160:
        S *= 2
    return S


def matvec_smem(B, K, N, prologue, pair=False):
    """Shared memory of one block of a matvec launch over [K, N] weights
    (csrc/decode.cu, matvec_smem), with the launch's own K split: the fp32
    reduction and partial over a 64-column tile, u transposed [kslice,
    MAXB] bf16 and, for a norm prologue, the whole staged input rows and
    the slice of the norm parameters. ``prologue``: "copy" (no norm),
    "ln_bf16", "ln_f32" (fp32 rows) or "rms_bf16"."""
    maxb = 8 if B <= 8 else 16
    S = _split_for(-(-N // 64), pair)
    kslice = -(-(-(-K // S)) // 8) * 8
    smem = 9 * maxb * 64 * 4 + kslice * maxb * 2
    if prologue == "copy":
        return smem
    row_bytes = 4 if prologue == "ln_f32" else 2
    n_par = 1 if prologue == "rms_bf16" else 2
    return smem + B * K * row_bytes + n_par * kslice * 4


def _check_launches(fn, B, launches):
    """Refuse a call before launching when one of its matvec launches
    ``(what, K, N, prologue, pair)`` needs more shared memory than a
    block may have."""
    for what, K, N, prologue, pair in launches:
        need = matvec_smem(B, K, N, prologue, pair)
        if need > MAX_SMEM:
            raise ValueError(
                f"{fn}: the {what} launch needs {need} B of shared memory a "
                f"block at B={B} slots, K={K}, N={N} (at most {MAX_SMEM}; "
                f"{ROADMAP_DECODE_VARIANTS})")


def _vec(a, L):
    """[L, n] view of a per-layer vector stack ([L, 1, n] accepted)."""
    return a.reshape(L, -1)


def _layer_ptr(fn, layer, device):
    """Device pointer of the kernel's layer index: a one-element int32
    tensor on the card, which the kernel reads there (no host sync)."""
    if not isinstance(layer, torch.Tensor) or layer.device != device \
            or layer.dtype != torch.int32 or layer.numel() != 1:
        raise ValueError(f"{fn}: layer must be a one-element int32 tensor "
                         f"on {device}")
    return layer.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def ln_qkv_stacked(x, ln_w, ln_b, w_stack, s, b, layer, eps=1e-5,
                   norm="layer"):
    """LayerNorm (or RMSNorm) + packed projection over a layer-stacked
    weight; see ln_qkv_stacked_plain. ``norm="rms"`` takes no ln_b or b
    (pass None)."""
    if x.device.type == "cpu":
        return ln_qkv_stacked_plain(x, ln_w, ln_b, w_stack, s, b, layer,
                                    eps, norm)
    fn = "ln_qkv_stacked"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if norm not in ("layer", "rms"):
        raise ValueError(f"{fn}: norm must be 'layer' or 'rms', got "
                         f"{norm!r}")
    rms = norm == "rms"
    dev = x.device
    B, E = x.shape
    L, _, N = w_stack.shape
    vecs = [("ln_w", _vec(ln_w, L), (L, E)), ("s", s, (L,))]
    if not rms:
        vecs += [("ln_b", _vec(ln_b, L), (L, E)), ("b", _vec(b, L), (L, N))]
    _check(fn, "x", x, torch.bfloat16, (B, E), dev)
    _check(fn, "w_stack", w_stack, torch.bfloat16, (L, E, N), dev)
    for name, t, shp in vecs:
        _check(fn, name, t, torch.float32, shp, dev)
    if not 1 <= B <= MAX_SLOTS or E % 8 or N % 8:
        raise ValueError(f"{fn}: needs 1 <= B <= {MAX_SLOTS} and E, N "
                         f"multiples of 8, got B={B} E={E} N={N}")
    _check_launches(fn, B, [("projection", E, N,
                             "rms_bf16" if rms else "ln_bf16", False)])
    v = {name: t for name, t, _ in vecs}
    lp = _layer_ptr(fn, layer, dev)
    lib = builder.kernels()
    out = torch.empty((B, N), dtype=x.dtype, device=dev)
    lib.call("dstpu_ln_qkv_stacked", x.data_ptr(), v["ln_w"].data_ptr(),
             _ptr(v.get("ln_b")), w_stack.data_ptr(), s.data_ptr(),
             _ptr(v.get("b")), lp, out.data_ptr(), B, E, N, int(rms),
             float(eps), _stream(dev))
    builder.launches[fn] += 1
    return out


def matvec_stacked(x, w_stack, s, layer):
    """x[B, K] · w_stack[layer] · s[layer] → [B, N], bias-free (LLaMA's
    o-projection); see matvec_stacked_plain."""
    if x.device.type == "cpu":
        return matvec_stacked_plain(x, w_stack, s, layer)
    fn = "matvec_stacked"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    dev = x.device
    B, K = x.shape
    L, _, N = w_stack.shape
    _check(fn, "x", x, torch.bfloat16, (B, K), dev)
    _check(fn, "w_stack", w_stack, torch.bfloat16, (L, K, N), dev)
    _check(fn, "s", s, torch.float32, (L,), dev)
    if not 1 <= B <= MAX_SLOTS or K % 8 or N % 8:
        raise ValueError(f"{fn}: needs 1 <= B <= {MAX_SLOTS} and K, N "
                         f"multiples of 8, got B={B} K={K} N={N}")
    _check_launches(fn, B, [("projection", K, N, "copy", False)])
    lp = _layer_ptr(fn, layer, dev)
    lib = builder.kernels()
    out = torch.empty((B, N), dtype=x.dtype, device=dev)
    lib.call("dstpu_matvec_stacked", x.data_ptr(), w_stack.data_ptr(),
             s.data_ptr(), lp, out.data_ptr(), B, K, N, _stream(dev))
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
    and bp are ignored, as in JAX; two launches)."""
    if x.device.type == "cpu":
        return out_ffn_stacked_plain(ctx, x, wp_stack, sp, bp, ln_w, ln_b,
                                     w1_stack, s1, b1, w2_stack, s2, b2,
                                     layer, act, eps, norm, w1b_stack, s1b,
                                     fuse_proj)
    fn = "out_ffn_stacked"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    gpt2 = (act, norm, fuse_proj) == ("gelu_tanh", "layer", True) \
        and w1b_stack is None
    llama = (act, norm, fuse_proj) == ("swiglu", "rms", False) \
        and w1b_stack is not None
    if not (gpt2 or llama):
        raise NotImplementedError(
            f"{fn}: the CUDA kernels take act='gelu_tanh', norm='layer', "
            f"fuse_proj=True or act='swiglu', norm='rms', fuse_proj=False; "
            f"got act={act!r} norm={norm!r} fuse_proj={fuse_proj} "
            f"({ROADMAP_DECODE_VARIANTS})")
    dev = x.device
    B, E = x.shape
    L, _, Fd = w1_stack.shape
    _check(fn, "x", x, torch.bfloat16, (B, E), dev)
    _check(fn, "w1_stack", w1_stack, torch.bfloat16, (L, E, Fd), dev)
    _check(fn, "w2_stack", w2_stack, torch.bfloat16, (L, Fd, E), dev)
    if not 1 <= B <= MAX_SLOTS or E % 8 or Fd % 8:
        raise ValueError(f"{fn}: needs 1 <= B <= {MAX_SLOTS} and E, F "
                         f"multiples of 8, got B={B} E={E} F={Fd}")
    lp = _layer_ptr(fn, layer, dev)
    h = torch.empty((B, Fd), dtype=x.dtype, device=dev)
    out = torch.empty((B, E), dtype=x.dtype, device=dev)
    if llama:
        ln_w = _vec(ln_w, L)
        _check(fn, "w1b_stack", w1b_stack, torch.bfloat16, (L, E, Fd), dev)
        for name, t, shp in (("ln_w", ln_w, (L, E)), ("s1", s1, (L,)),
                             ("s1b", s1b, (L,)), ("s2", s2, (L,))):
            _check(fn, name, t, torch.float32, shp, dev)
        _check_launches(fn, B, [("gate/up", E, Fd, "rms_bf16", True),
                                ("down", Fd, E, "copy", False)])
        builder.kernels().call(
            "dstpu_out_ffn_glu_stacked", x.data_ptr(), ln_w.data_ptr(),
            w1_stack.data_ptr(), s1.data_ptr(),
            w1b_stack.data_ptr(), s1b.data_ptr(), w2_stack.data_ptr(),
            s2.data_ptr(), lp, h.data_ptr(), out.data_ptr(), B, E, Fd,
            float(eps), _stream(dev))
        builder.launches[fn] += 1
        return out
    vecs = {"sp": (sp, (L,)), "s1": (s1, (L,)), "s2": (s2, (L,)),
            "bp": (_vec(bp, L), (L, E)), "ln_w": (_vec(ln_w, L), (L, E)),
            "ln_b": (_vec(ln_b, L), (L, E)), "b1": (_vec(b1, L), (L, Fd)),
            "b2": (_vec(b2, L), (L, E))}
    _check(fn, "ctx", ctx, torch.bfloat16, (B, E), dev)
    _check(fn, "wp_stack", wp_stack, torch.bfloat16, (L, E, E), dev)
    for name, (t, shp) in vecs.items():
        _check(fn, name, t, torch.float32, shp, dev)
    _check_launches(fn, B, [("out-projection", E, E, "copy", False),
                            ("up", E, Fd, "ln_f32", False),
                            ("down", Fd, E, "copy", False)])
    x1 = torch.empty((B, E), dtype=x.dtype, device=dev)
    x1f = torch.empty((B, E), dtype=torch.float32, device=dev)
    v = {k: t for k, (t, _) in vecs.items()}
    builder.kernels().call(
        "dstpu_out_ffn_stacked", ctx.data_ptr(), x.data_ptr(),
        wp_stack.data_ptr(), v["sp"].data_ptr(), v["bp"].data_ptr(),
        v["ln_w"].data_ptr(), v["ln_b"].data_ptr(), w1_stack.data_ptr(),
        v["s1"].data_ptr(), v["b1"].data_ptr(), w2_stack.data_ptr(),
        v["s2"].data_ptr(), v["b2"].data_ptr(), lp, x1.data_ptr(),
        x1f.data_ptr(), h.data_ptr(), out.data_ptr(), B, E, Fd, float(eps),
        _stream(dev))
    builder.launches[fn] += 1
    return out


def decode_attention_paged(q, k_pool, v_pool, pos, page_table, layer,
                           k_scale=None, v_scale=None, scale=None,
                           rows_per_step=None):
    """S=1 attention through a paged pool; see
    decode_attention_paged_plain. On CUDA: head dim 64 or 128, R <= 8
    query rows per KV head (GQA or multi-query). ``k_scale``/``v_scale``
    (the int8 pool) are not ported."""
    fn = "decode_attention_paged"
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(f"{fn}: the int8 pool ({ROADMAP_INT8})")
    B, H, R, D = q.shape
    if rows_per_step is not None and R % rows_per_step:
        raise ValueError(f"{fn}: R={R} is not a multiple of "
                         f"rows_per_step={rows_per_step}")
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, k_pool, v_pool, pos,
                                            page_table, layer, scale,
                                            rows_per_step)
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    dev = q.device
    Lyr, NB, Hp, page, Dp = k_pool.shape
    maxp = page_table.shape[1]
    _check(fn, "q", q, torch.bfloat16, (B, H, R, D), dev)
    _check(fn, "k_pool", k_pool, torch.bfloat16, (Lyr, NB, H, page, D), dev)
    _check(fn, "v_pool", v_pool, torch.bfloat16, (Lyr, NB, H, page, D), dev)
    _check(fn, "pos", pos, torch.int32, (B,), dev)
    _check(fn, "page_table", page_table, torch.int32, (B, maxp), dev)
    if D not in ATTN_HEAD_DIMS:
        raise NotImplementedError(
            f"{fn}: the CUDA kernel takes head dim 64 or 128, got {D} "
            f"({ROADMAP_DECODE_VARIANTS})")
    if not 1 <= R <= MAX_ROWS or page % PAGE_MULTIPLE:
        raise ValueError(f"{fn}: needs 1 <= R <= {MAX_ROWS} and page a "
                         f"multiple of {PAGE_MULTIPLE}, got R={R} "
                         f"page={page}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    lp = _layer_ptr(fn, layer, dev)
    lib = builder.kernels()
    out = torch.empty_like(q)
    lib.call("dstpu_decode_attention_paged", q.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(), pos.data_ptr(),
             page_table.data_ptr(), lp, out.data_ptr(), B, H, R, D, NB,
             page, maxp, int(rows_per_step or 0), scale, _stream(dev))
    builder.launches[fn] += 1
    return out
