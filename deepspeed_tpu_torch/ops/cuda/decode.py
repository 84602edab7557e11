"""Decode-tick kernels: CUDA (csrc/decode.cu) and their plain versions.

Replaces three Pallas kernels of ``deepspeed_tpu/ops/pallas/decode.py``:

- ``ln_qkv_stacked``         ← ``ln_qkv_int8_stacked``    (:432, kernel :496)
- ``out_ffn_stacked``        ← ``out_ffn_int8_stacked``   (:698, kernel :1000)
- ``decode_attention_paged`` ← ``decode_attention_paged`` (:854, kernel :931)

Layouts follow the JAX functions: weights are layer-stacked ``[L, in,
out]`` and indexed at ``layer`` inside the kernel (on CUDA ``layer`` is
a one-element int32 tensor on the card; the plain versions also take an
int); per-layer vectors are ``[L, n]`` (``[L, 1, n]`` is accepted);
scales are ``[L]`` fp32. A CPU
tensor takes the plain version, which implements every option of the
JAX function; a CUDA tensor launches the kernel or raises. The CUDA
kernels take bf16 activations and weights with LayerNorm and biases in
fp32, gelu_tanh, and the fp paged pool.
"""

import math

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.config.config import ROADMAP_INT8
from deepspeed_tpu_torch.ops.cuda import builder

ROADMAP_LLAMA = ("ROADMAP.md queue 2, item \"the LLaMA serving adapter "
                 "(swiglu/rms, matvec_int8_stacked, GQA)\"")
ROADMAP_FP32 = ("ROADMAP.md queue 2, item \"fp32 activations on the "
                "CUDA decode kernels\"")
MAX_SLOTS = 16          # the matvec kernels' register accumulator bound
# the paged-attention kernel's geometry: two lanes per key over a 64-wide
# head, 16-key groups inside a page, at most 8 query rows per KV head
ATTN_HEAD_DIM, PAGE_MULTIPLE, MAX_ROWS = 64, 16, 8
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


def _matvec_smem(B, K, stage_bytes):
    """Shared memory of one matvec block (csrc/decode.cu, matvec_smem) when
    one block takes all of K: the fp32 reduction and partial over a
    64-column tile, u transposed [K, MAXB] bf16 and, for a LayerNorm
    prologue, the staged input rows and the layer's fp32 ln_w, ln_b."""
    maxb = 8 if B <= 8 else 16
    staged = B * K * stage_bytes + 2 * K * 4 if stage_bytes else 0
    return 9 * maxb * 64 * 4 + K * maxb * 2 + staged


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


def ln_qkv_stacked(x, ln_w, ln_b, w_stack, s, b, layer, eps=1e-5,
                   norm="layer"):
    """LayerNorm + packed projection over a layer-stacked weight; see
    ln_qkv_stacked_plain."""
    if x.device.type == "cpu":
        return ln_qkv_stacked_plain(x, ln_w, ln_b, w_stack, s, b, layer,
                                    eps, norm)
    fn = "ln_qkv_stacked"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if norm != "layer":
        raise NotImplementedError(f"{fn}: norm={norm!r} ({ROADMAP_LLAMA})")
    dev = x.device
    B, E = x.shape
    L, _, N = w_stack.shape
    ln_w, ln_b, b = _vec(ln_w, L), _vec(ln_b, L), _vec(b, L)
    _check(fn, "x", x, torch.bfloat16, (B, E), dev)
    _check(fn, "w_stack", w_stack, torch.bfloat16, (L, E, N), dev)
    for name, t, shp in (("ln_w", ln_w, (L, E)), ("ln_b", ln_b, (L, E)),
                         ("b", b, (L, N)), ("s", s, (L,))):
        _check(fn, name, t, torch.float32, shp, dev)
    if not 1 <= B <= MAX_SLOTS or E % 8 or N % 8 \
            or _matvec_smem(B, E, 2) > MAX_SMEM:
        raise ValueError(f"{fn}: needs 1 <= B <= {MAX_SLOTS}, E and N "
                         f"multiples of 8 and the [B, E] rows in one "
                         f"block's shared memory, got B={B} E={E} N={N}")
    lp = _layer_ptr(fn, layer, dev)
    lib = builder.kernels()
    out = torch.empty((B, N), dtype=x.dtype, device=dev)
    lib.call("dstpu_ln_qkv_stacked", x.data_ptr(), ln_w.data_ptr(),
             ln_b.data_ptr(), w_stack.data_ptr(), s.data_ptr(),
             b.data_ptr(), lp, out.data_ptr(), B, E, N, float(eps),
             _stream(dev))
    builder.launches[fn] += 1
    return out


def out_ffn_stacked(ctx, x, wp_stack, sp, bp, ln_w, ln_b, w1_stack, s1,
                    b1, w2_stack, s2, b2, layer, act="gelu_tanh", eps=1e-5,
                    norm="layer", w1b_stack=None, s1b=None, fuse_proj=True):
    """Attention out-projection + residual + LayerNorm + FFN + residual;
    see out_ffn_stacked_plain. On CUDA: three launches per call."""
    if x.device.type == "cpu":
        return out_ffn_stacked_plain(ctx, x, wp_stack, sp, bp, ln_w, ln_b,
                                     w1_stack, s1, b1, w2_stack, s2, b2,
                                     layer, act, eps, norm, w1b_stack, s1b,
                                     fuse_proj)
    fn = "out_ffn_stacked"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if act != "gelu_tanh" or norm != "layer" or not fuse_proj \
            or w1b_stack is not None:
        raise NotImplementedError(
            f"{fn}: the CUDA kernel takes act='gelu_tanh', norm='layer', "
            f"fuse_proj=True; got act={act!r} norm={norm!r} "
            f"fuse_proj={fuse_proj} ({ROADMAP_LLAMA})")
    dev = x.device
    B, E = x.shape
    L, _, Fd = w1_stack.shape
    vecs = {"sp": (sp, (L,)), "s1": (s1, (L,)), "s2": (s2, (L,)),
            "bp": (_vec(bp, L), (L, E)), "ln_w": (_vec(ln_w, L), (L, E)),
            "ln_b": (_vec(ln_b, L), (L, E)), "b1": (_vec(b1, L), (L, Fd)),
            "b2": (_vec(b2, L), (L, E))}
    _check(fn, "ctx", ctx, torch.bfloat16, (B, E), dev)
    _check(fn, "x", x, torch.bfloat16, (B, E), dev)
    _check(fn, "wp_stack", wp_stack, torch.bfloat16, (L, E, E), dev)
    _check(fn, "w1_stack", w1_stack, torch.bfloat16, (L, E, Fd), dev)
    _check(fn, "w2_stack", w2_stack, torch.bfloat16, (L, Fd, E), dev)
    for name, (t, shp) in vecs.items():
        _check(fn, name, t, torch.float32, shp, dev)
    if not 1 <= B <= MAX_SLOTS or E % 8 or Fd % 8:
        raise ValueError(f"{fn}: needs 1 <= B <= {MAX_SLOTS} and E, F "
                         f"multiples of 8, got B={B} E={E} F={Fd}")
    if max(_matvec_smem(B, E, 4), _matvec_smem(B, Fd, 0)) \
            > MAX_SMEM:
        raise ValueError(f"{fn}: the [B, F] activation ({B}x{Fd}) does not "
                         f"fit one block's shared memory")
    lp = _layer_ptr(fn, layer, dev)
    lib = builder.kernels()
    x1 = torch.empty((B, E), dtype=x.dtype, device=dev)
    x1f = torch.empty((B, E), dtype=torch.float32, device=dev)
    h = torch.empty((B, Fd), dtype=x.dtype, device=dev)
    out = torch.empty((B, E), dtype=x.dtype, device=dev)
    v = {k: t for k, (t, _) in vecs.items()}
    lib.call("dstpu_out_ffn_stacked", ctx.data_ptr(), x.data_ptr(),
             wp_stack.data_ptr(), v["sp"].data_ptr(), v["bp"].data_ptr(),
             v["ln_w"].data_ptr(), v["ln_b"].data_ptr(),
             w1_stack.data_ptr(), v["s1"].data_ptr(), v["b1"].data_ptr(),
             w2_stack.data_ptr(), v["s2"].data_ptr(), v["b2"].data_ptr(),
             lp, x1.data_ptr(), x1f.data_ptr(), h.data_ptr(),
             out.data_ptr(), B, E, Fd, float(eps), _stream(dev))
    builder.launches[fn] += 1
    return out


def decode_attention_paged(q, k_pool, v_pool, pos, page_table, layer,
                           k_scale=None, v_scale=None, scale=None,
                           rows_per_step=None):
    """S=1 attention through a paged pool; see
    decode_attention_paged_plain. ``k_scale``/``v_scale`` (the int8
    pool) are not ported."""
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
    if D != ATTN_HEAD_DIM:
        raise NotImplementedError(
            f"{fn}: the CUDA kernel takes head dim {ATTN_HEAD_DIM}, got {D} "
            f"({ROADMAP_LLAMA})")
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
             page_table.data_ptr(), lp, out.data_ptr(), B, H, R, NB,
             page, maxp, int(rows_per_step or 0), scale, _stream(dev))
    builder.launches[fn] += 1
    return out
