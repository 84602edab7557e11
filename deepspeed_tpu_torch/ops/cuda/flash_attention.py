"""Flash attention: the CUDA kernels (csrc/flash_attention.cu) and their
plain PyTorch versions.

Replaces ``deepspeed_tpu/ops/pallas/flash_attention.py:580``
``flash_attention``: the forward (``_flash_fwd`` :149, ``_fwd_kernel``
:122) and the recompute backward (``_flash_bwd`` :257 with
``_bwd_fused_kernel`` :192, and ``_flash_bwd_chunked`` :457 with
``_bwd_dq_kernel_chunked`` :367 and ``_bwd_dkv_kernel_chunked`` :405).
The backward runs as two kernels, dk/dv and dq, each tiling any S. The
forward takes head dim 64 (GPT-2) or 128 (LLaMA), the backward 64. A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.

The forward is a persistent, TMA-fed, warp-specialised wgmma kernel
(csrc/flash_attention.cu ``flash_fwd_tma_kernel``); ``fwd_geometry``,
``fwd_walk`` and ``fwd_blocks`` mirror its launch (tiles, head groups,
stages, shared memory, which block takes which tile).
"""

import collections
import functools
import math

import torch

from deepspeed_tpu_torch.ops.cuda import builder

NEG_INF = -1e30
HEAD_DIM = 64              # the backward kernels' head dim (GPT-2's)
FWD_HEAD_DIMS = (64, 128)  # the forward's: GPT-2's and LLaMA's
ROADMAP_FLASH = ("ROADMAP.md queue 2, item \"flash attention: other head "
                 "dims and fp32\"")
# by head dim: the forward's consumer warpgroups take turns issuing their
# products, so that one's softmax runs under the other's (on an H100 this
# measured faster at D 64 and slower at D 128; chip_smoke.py times the
# other setting on every row)
PINGPONG = {64: True, 128: False}
L2_GROUP_BYTES = 24 << 20   # the K/V bytes of the heads walked together

FwdGeometry = collections.namedtuple(
    "FwdGeometry",
    "q_tile key_tile q_tiles group tiles grid threads k_stages v_stages "
    "smem")


@functools.lru_cache(maxsize=None)
def fwd_geometry(S, D, H, Hkv, B=1, sms=132):
    """The forward's launch at head dim D (csrc/flash_attention.cu
    ``FwdCfg``, ``launch_fwd``): 128-row q tiles (two consumer
    warpgroups of 64 rows) over 128-key K/V tiles; a persistent grid of
    min(tiles, SMs) blocks walking the q tiles x B*H tiles in groups of
    ``group`` heads (all, if their K/V fit in 24 MiB of L2; else the most
    that fit, rounded down to a multiple of grid / gcd(grid, q tiles) so
    that a group spans whole rounds; in a group the q tiles longest
    first), block b taking the rounds in a snake (``fwd_blocks``); 384
    threads; K and V rings of 4 stages (D 64; at D 128 2 and 3); shared
    memory = 1024 (alignment) + Q + O + the K and V stages + 256
    (mbarriers)."""
    if D not in FWD_HEAD_DIMS:
        raise ValueError(f"fwd_geometry: head dim {D} is not 64 or 128")
    q_tile = key_tile = 128
    k_stages, v_stages = (4, 4) if D == 64 else (2, 3)
    smem = (1024 + 2 * q_tile * D * 2
            + (k_stages + v_stages) * key_tile * D * 2 + 256)
    q_tiles = -(-S // q_tile)
    tiles, grid = q_tiles * B * H, min(q_tiles * B * H, sms)
    fit = L2_GROUP_BYTES // max(4 * S * D * Hkv // H, 1)
    unit = grid // math.gcd(grid, q_tiles)
    group = (B * H if fit >= B * H else fit // unit * unit if fit >= unit
             else max(fit, 1))
    return FwdGeometry(q_tile, key_tile, q_tiles, group, tiles, grid, 384,
                       k_stages, v_stages, smem)


def fwd_blocks(S, D, H, Hkv, B=1):
    """The walk indices each block of the launch takes, in order
    (``snake`` in csrc/flash_attention.cu): round r's index r * grid + b,
    or r * grid + grid - 1 - b in odd rounds."""
    g = fwd_geometry(S, D, H, Hkv, B)
    return [[w for w in (r * g.grid + (g.grid - 1 - b if r % 2 else b)
                         for r in range(-(-g.tiles // g.grid)))
             if w < g.tiles] for b in range(g.grid)]


def fwd_walk(S, D, H, Hkv, B=1):
    """The (b*h, q tile) of each tile of the launch's walk, in walk
    order (``fwd_tile`` in csrc/flash_attention.cu)."""
    g = fwd_geometry(S, D, H, Hkv, B)
    BH, walk = B * H, []
    for w in range(g.tiles):
        gi, j = divmod(w, g.group * g.q_tiles)
        gsize = min(g.group, BH - gi * g.group)
        walk.append((gi * g.group + j % gsize, g.q_tiles - 1 - j // gsize))
    return walk


def _scale(scale, D):
    return float(scale) if scale is not None else 1.0 / math.sqrt(D)


def _causal_keep(S, device):
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """(o, lse) for [B, H, S, D] q and [B, Hkv, S, D] k/v: the kernel's
    arithmetic in plain PyTorch — fp32 scores and softmax, p rounded to
    v's dtype before the V product (as ``_fwd_block_step`` does), o in
    q's dtype, lse [B, H, S] fp32. K/V heads map to q heads by index."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    scale = _scale(scale, D)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(S, q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _bwd_p_ds(q, k, v, do, lse, delta, causal, scale):
    """(p, ds) fp32 for whole [B, H, S, S] score rows: ``_bwd_ds_block``
    (flash_attention.py:96) over every tile at once."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[2], q.device), NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False,
                                  scale=None):
    """(dk, dv) of the dk/dv kernel in plain PyTorch, for full-head
    [B, H, S, D] q, k, v, do and fp32 [B, H, S] lse, delta: p and ds
    rounded to q's dtype before their products, dk = scale·dsᵀ·q,
    dv = pᵀ·do, both in q's dtype."""
    scale = _scale(scale, q.shape[-1])
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=False,
                                 scale=None):
    """dq of the dq kernel in plain PyTorch: dq = scale·ds·k, ds rounded
    to q's dtype before the product, dq in q's dtype."""
    scale = _scale(scale, q.shape[-1])
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale)
    return (torch.matmul(ds.to(q.dtype).float(), k.float()) * scale).to(
        q.dtype)


def _check_bwd_args(name, q, k, v, do, lse, delta):
    B, H, S, D = q.shape
    for t_name, t in (("k", k), ("v", v), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name}: {t_name} {tuple(t.shape)} vs q "
                             f"{tuple(q.shape)} (K/V take the full heads)")
    for t_name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {t_name} must be fp32 [B, H, S], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t_name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse),
                      ("delta", delta)):
        if t.device != q.device:
            raise ValueError(f"{name}: {t_name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
    for t_name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"{name}: the CUDA kernel takes bf16, got {t_name} {t.dtype} "
                f"({ROADMAP_FLASH})")
    if D != HEAD_DIM:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes head dim {HEAD_DIM}, got {D} "
            f"({ROADMAP_FLASH})")


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """(dk, dv) — see flash_attention_bwd_dkv_plain. On CUDA: bf16,
    contiguous, head dim 64."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                             scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dkv: unsupported device "
                         f"{q.device}")
    _check_bwd_args("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    B, H, S, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if S == 0:
        return dk, dv
    builder.kernels().call(
        "dstpu_flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B * H, S, _scale(scale, D), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    builder.launches["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None):
    """dq — see flash_attention_bwd_dq_plain. On CUDA: bf16, contiguous,
    head dim 64."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dq: unsupported device "
                         f"{q.device}")
    _check_bwd_args("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    B, H, S, D = q.shape
    dq = torch.empty_like(q)
    if S == 0:
        return dq
    builder.kernels().call(
        "dstpu_flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B * H, S, _scale(scale, D), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    builder.launches["flash_attention_bwd_dq"] += 1
    return dq


def _bwd(q, k, v, o, lse, do, causal, scale, dkv_fn, dq_fn):
    """The backward around its two kernels, as ``_flash_attention_bwd``
    (flash_attention.py:543) wraps them: delta = rowsum(do·o) in fp32
    (:260), K/V repeated to the full heads for GQA and dk/dv summed back
    over the heads that share a KV head."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = dkv_fn(q, k, v, do, lse, delta, causal, scale)
    dq = dq_fn(q, k, v, do, lse, delta, causal, scale)
    if rep > 1:
        dk = dk.reshape(B, Hkv, rep, S, D).sum(2).to(dk.dtype)
        dv = dv.reshape(B, Hkv, rep, S, D).sum(2).to(dv.dtype)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None):
    """(dq, dk, dv) for [B, H, S, D] q, [B, Hkv, S, D] k/v, the forward's
    o and lse, and the output cotangent do: the plain versions of both
    kernels, every output in q's dtype."""
    return _bwd(q, k, v, o, lse, do, causal, scale,
                flash_attention_bwd_dkv_plain, flash_attention_bwd_dq_plain)


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """(dq, dk, dv) — see flash_attention_bwd_plain. A CPU tensor takes the
    plain versions; a CUDA tensor launches both kernels or raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention_bwd: {q.shape[1]} q heads are not "
                         f"a multiple of {k.shape[1]} kv heads")
    return _bwd(q, k, v, o, lse, do, causal, scale, flash_attention_bwd_dkv,
                flash_attention_bwd_dq)


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """(o, lse) — see flash_attention_fwd_plain. On CUDA: bf16,
    contiguous [B, H, S, D] q and [B, Hkv, S, D] k/v with H % Hkv == 0,
    D 64 or 128."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    B, H, S, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[2] != S or k.shape[3] != D:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"flash_attention_fwd: {H} q heads are not a "
                         f"multiple of {Hkv} kv heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}")
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"flash_attention_fwd: the CUDA kernel takes bf16, got "
                f"{name} {t.dtype} ({ROADMAP_FLASH})")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"contiguous")
    if D not in FWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_fwd: the CUDA kernel takes head dim 64 or "
            f"128, got {D} ({ROADMAP_FLASH})")
    scale = _scale(scale, D)
    # TMA reads from 16-byte aligned bases: a view at an odd offset is
    # copied into a fresh (aligned) tensor
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    lib = builder.kernels()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if S == 0:
        return o, lse
    lib.call("dstpu_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), lse.data_ptr(), B * H, H, Hkv, S, D, scale,
             int(bool(causal)), int(PINGPONG[D]),
             torch.cuda.current_stream(q.device).cuda_stream)
    builder.launches["flash_attention_fwd"] += 1
    return o, lse


def flash_attention(q, k, v, causal=False, scale=None):
    """[B, H, S, D] flash attention forward (the output only)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
