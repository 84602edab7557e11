"""Flash attention: the CUDA kernels (csrc/flash_attention.cu) and their
plain PyTorch versions.

Replaces ``deepspeed_tpu/ops/pallas/flash_attention.py:580``
``flash_attention``: the forward (``_flash_fwd`` :149, ``_fwd_kernel``
:122) and the recompute backward (``_flash_bwd`` :257 with
``_bwd_fused_kernel`` :192, and ``_flash_bwd_chunked`` :457 with
``_bwd_dq_kernel_chunked`` :367 and ``_bwd_dkv_kernel_chunked`` :405).
Both directions take head dim 64 (GPT-2) or 128 (LLaMA) and tile any S.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.

The forward is a persistent, TMA-fed, warp-specialised wgmma kernel
(csrc/flash_attention.cu ``flash_fwd_tma_kernel``); ``fwd_geometry``,
``fwd_walk`` and ``fwd_blocks`` mirror its launch (tiles, head groups,
stages, shared memory, which block takes which tile). The backward is
one pass of the same kind (``flash_bwd_tma_kernel``: each score tile and
its exp computed once, dq summed in fp32 in a fixed order) after a delta
reduction (``flash_bwd_delta_kernel``); ``bwd_geometry``, ``bwd_walk``,
``bwd_blocks`` and ``bwd_dq_waits`` mirror its launch, and
``flash_attention_bwd_kernel_tiles`` its arithmetic in its order.
"""

import collections
import functools
import math

import torch

from deepspeed_tpu_torch.ops.cuda import builder

NEG_INF = -1e30
HEAD_DIMS = (64, 128)   # the kernels' head dims: GPT-2's and LLaMA's
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
    if D not in HEAD_DIMS:
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


BWD_Q_TILE, BWD_KEY_TILE = 64, 128   # the backward's q tile, work item
BwdGeometry = collections.namedtuple(
    "BwdGeometry",
    "q_tile key_tile q_tiles key_tiles items group grid threads kv_stages "
    "q_stages dq_stages smem")


@functools.lru_cache(maxsize=None)
def bwd_geometry(S, D, H, B=1, sms=132):
    """The backward's launch at head dim D over B*H full heads
    (csrc/flash_attention.cu ``BwdCfg``, ``launch_bwd``): work items of
    one head's 128 keys (two consumer warpgroups of 64), each over q
    tiles of 64 rows; a persistent grid of min(items, SMs) blocks of 384
    threads walking the items in groups of ``group`` heads (all, if their
    Q, dO, lse, delta and fp32 dq sums, 8·S·D + 8·S bytes a head, fit in
    24 MiB of L2; else the most that fit, rounded down to a multiple of
    unit = grid / gcd(grid, key tiles) so that a group spans whole rounds;
    unit heads when fewer fit but unit heads fit in 48 MiB; else as many
    as fit); K/V stages 2 (D 64) or 1 (D 128), Q/dO stages 4 or 2, dQ
    staging tiles 3 or 2; shared memory = 1024 (alignment) + the K/V, Q/dO, two
    dS^T and dQ staging tiles + 512 bytes of lse and delta a Q/dO stage
    + 256 (mbarriers)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"bwd_geometry: head dim {D} is not 64 or 128")
    kv_stages, q_stages, dq_stages = (2, 4, 3) if D == 64 else (1, 2, 2)
    smem = (1024 + kv_stages * 2 * BWD_KEY_TILE * D * 2
            + q_stages * 2 * BWD_Q_TILE * D * 2
            + 2 * BWD_KEY_TILE * BWD_Q_TILE * 2
            + dq_stages * BWD_Q_TILE * D * 4 + q_stages * 2 * BWD_Q_TILE * 4
            + 256)
    q_tiles, key_tiles = -(-S // BWD_Q_TILE), -(-S // BWD_KEY_TILE)
    BH = B * H
    items = key_tiles * BH
    grid = min(items, sms)
    head = 8 * S * D + 8 * S
    fit = L2_GROUP_BYTES // head
    unit = grid // math.gcd(grid, key_tiles)
    group = (BH if fit >= BH else fit // unit * unit if fit >= unit
             else unit if unit * head <= 2 * L2_GROUP_BYTES
             else max(fit, 1))
    return BwdGeometry(BWD_Q_TILE, BWD_KEY_TILE, q_tiles, key_tiles, items,
                       group, grid, 384, kv_stages, q_stages, dq_stages,
                       smem)


def _bwd_first_q_tile(kt, causal):
    """The first q tile a key tile's item visits: the diagonal one under
    causal masking (the tiles above it see none of its keys), else 0."""
    return 2 * kt if causal else 0


def _bwd_last_key_tile(i, key_tiles, causal):
    """The last key tile that adds to q tile i's dq: the diagonal one under
    causal masking, else the last."""
    return i // 2 if causal else key_tiles - 1


def bwd_walk(S, D, H, B=1):
    """The (b*h, key tile) of each item of the backward's walk, in walk
    order (``bwd_item`` in csrc/flash_attention.cu): heads in groups of
    ``group``, in a group key tile by key tile across its heads, so that
    under causal masking a group's longest items come first."""
    g = bwd_geometry(S, D, H, B)
    BH, walk = B * H, []
    for w in range(g.items):
        gi, j = divmod(w, g.group * g.key_tiles)
        gsize = min(g.group, BH - gi * g.group)
        kt, r = divmod(j, gsize)
        walk.append((gi * g.group + r, kt))
    return walk


def bwd_blocks(S, D, H, B=1):
    """The walk indices each block of the backward's launch takes, in
    order: the forward's snake over rounds of ``grid`` items."""
    g = bwd_geometry(S, D, H, B)
    return [[w for w in (r * g.grid + (g.grid - 1 - b if r % 2 else b)
                         for r in range(-(-g.items // g.grid)))
             if w < g.items] for b in range(g.grid)]


def bwd_item_q_tiles(S, kt, causal):
    """The q tiles a key tile's item visits."""
    return -(-S // BWD_Q_TILE) - _bwd_first_q_tile(kt, causal)


def bwd_dq_waits(S, D, H, B=1, causal=True):
    """Every ordered wait of the backward's dQ writer, as (walk index of
    the waiting item, walk index of the item waited on, b*h, q tile): the
    contribution of key tile kt > 0 to a q tile waits until key tile
    kt - 1 has added its own (the kernel's counter equals kt)."""
    g = bwd_geometry(S, D, H, B)
    index = {item: w for w, item in enumerate(bwd_walk(S, D, H, B))}
    waits = []
    for (bh, kt), w in index.items():
        if kt == 0:
            continue
        for i in range(_bwd_first_q_tile(kt, causal), g.q_tiles):
            waits.append((w, index[(bh, kt - 1)], bh, i))
    return waits


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


def flash_attention_bwd_delta_plain(o, do):
    """delta = rowsum(do·o) in fp32, [B, H, S] (flash_attention.py:260)."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd_delta(o, do):
    """delta — see flash_attention_bwd_delta_plain. On CUDA: bf16,
    contiguous [B, H, S, D] o and do, D 64 or 128; one pass over both."""
    if o.device.type == "cpu":
        return flash_attention_bwd_delta_plain(o, do)
    if o.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_delta: unsupported device "
                         f"{o.device}")
    if do.shape != o.shape or do.device != o.device:
        raise ValueError(f"flash_attention_bwd_delta: do {tuple(do.shape)} "
                         f"on {do.device} vs o {tuple(o.shape)}")
    B, H, S, D = o.shape
    for name, t in (("o", o), ("do", do)):
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"flash_attention_bwd_delta: the CUDA kernel takes bf16, "
                f"got {name} {t.dtype} ({ROADMAP_FLASH})")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd_delta: {name} must be "
                             f"contiguous")
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_bwd_delta: the CUDA kernel takes head dim 64 "
            f"or 128, got {D} ({ROADMAP_FLASH})")
    o, do = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (o, do))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=o.device)
    if delta.numel() == 0:
        return delta
    builder.kernels().call(
        "dstpu_flash_bwd_delta", o.data_ptr(), do.data_ptr(),
        delta.data_ptr(), B * H * S, D,
        torch.cuda.current_stream(o.device).cuda_stream)
    builder.launches["flash_attention_bwd_delta"] += 1
    return delta


def flash_attention_bwd_kernel_plain(q, k, v, do, lse, delta, causal=False,
                                     scale=None):
    """(dq, dk, dv) of the backward kernel in plain PyTorch over whole
    score rows, for full-head [B, H, S, D] q, k, v, do and fp32 [B, H, S]
    lse, delta: p and ds rounded to q's dtype before their products,
    dq = scale·ds·k, dk = scale·dsᵀ·q, dv = pᵀ·do, each in q's dtype."""
    scale = _scale(scale, q.shape[-1])
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale)
    dsl = ds.to(q.dtype).float()
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(dsl.transpose(-1, -2), q.float()) * scale
    dq = torch.matmul(dsl, k.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_kernel_tiles(q, k, v, do, lse, delta, causal=False,
                                     scale=None):
    """(dq, dk, dv) as the backward kernel computes them, tile by tile and
    in its order: work items of BWD_KEY_TILE keys (a head's key tiles
    ascending, as ``bwd_walk`` takes them), in each the q tiles of
    BWD_Q_TILE rows from the last down to the diagonal; per tile pair p
    and ds in fp32, rounded to q's dtype before the products; dk and dv
    summed in fp32 over the item's q tiles; a q tile's dq summed over its
    key tiles in ascending order, the first stored and each later one
    added in fp32, the last contributor's sum scaled and cast
    (``bwd_dq_waits``)."""
    B, H, S, D = q.shape
    scale, dt = _scale(scale, D), q.dtype
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    n_qt, n_kt = -(-S // BWD_Q_TILE), -(-S // BWD_KEY_TILE)
    acc = [None] * n_qt
    rows = torch.arange(S, device=q.device)
    for kt in range(n_kt):
        k0, k1 = kt * BWD_KEY_TILE, min(S, (kt + 1) * BWD_KEY_TILE)
        kt_, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        dk_acc = torch.zeros(B, H, k1 - k0, D, device=q.device)
        dv_acc = torch.zeros(B, H, k1 - k0, D, device=q.device)
        for i in reversed(range(_bwd_first_q_tile(kt, causal), n_qt)):
            q0, q1 = i * BWD_Q_TILE, min(S, (i + 1) * BWD_Q_TILE)
            qt, dot = qf[:, :, q0:q1], dof[:, :, q0:q1]
            s = torch.matmul(qt, kt_.transpose(-1, -2)) * scale
            if causal:
                keep = rows[q0:q1, None] >= rows[None, k0:k1]
                s = s.masked_fill(~keep, NEG_INF)
            p = torch.exp(s - lse[:, :, q0:q1, None])
            dp = torch.matmul(dot, vt.transpose(-1, -2))
            ds = p * (dp - delta[:, :, q0:q1, None])
            pl, dsl = p.to(dt).float(), ds.to(dt).float()
            dv_acc += torch.matmul(pl.transpose(-1, -2), dot)
            dk_acc += torch.matmul(dsl.transpose(-1, -2), qt)
            part = torch.matmul(dsl, kt_)
            acc[i] = part if kt == 0 else acc[i] + part
            if kt == _bwd_last_key_tile(i, n_kt, causal):
                dq[:, :, q0:q1] = (acc[i] * scale).to(dt)
        dk[:, :, k0:k1] = (dk_acc * scale).to(dt)
        dv[:, :, k0:k1] = dv_acc.to(dt)
    return dq, dk, dv


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
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes head dim 64 or 128, got {D} "
            f"({ROADMAP_FLASH})")


def flash_attention_bwd_kernel(q, k, v, do, lse, delta, causal=False,
                               scale=None):
    """(dq, dk, dv) — see flash_attention_bwd_kernel_plain. On CUDA: bf16,
    contiguous, full-head [B, H, S, D] tensors, D 64 or 128; one launch
    (counted as ``flash_attention_bwd``) with its fp32 dq accumulators and
    their counters allocated here."""
    if q.device.type == "cpu":
        return flash_attention_bwd_kernel_plain(q, k, v, do, lse, delta,
                                                causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    _check_bwd_args("flash_attention_bwd", q, k, v, do, lse, delta)
    B, H, S, D = q.shape
    # TMA reads from 16-byte aligned bases
    q, k, v, do = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    n_qt = -(-S // BWD_Q_TILE)
    dq_acc = torch.empty(B * H * n_qt * BWD_Q_TILE * D, dtype=torch.float32,
                         device=q.device)
    counters = torch.zeros(B * H * n_qt, dtype=torch.int32, device=q.device)
    builder.kernels().call(
        "dstpu_flash_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(), counters.data_ptr(),
        B * H, S, D, _scale(scale, D), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    builder.launches["flash_attention_bwd"] += 1
    return dq, dk, dv


def _bwd(q, k, v, o, lse, do, causal, scale, delta_fn, kernel_fn):
    """The backward around its kernel, as ``_flash_attention_bwd``
    (flash_attention.py:543) wraps it: delta = rowsum(do·o) in fp32
    (:260), K/V repeated to the full heads for GQA and dk/dv summed back
    over the heads that share a KV head."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"flash_attention_bwd: {H} q heads are not a "
                         f"multiple of {Hkv} kv heads")
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    do = do.contiguous()
    delta = delta_fn(o, do)
    dq, dk, dv = kernel_fn(q, k, v, do, lse, delta, causal, scale)
    if rep > 1:
        dk = dk.reshape(B, Hkv, rep, S, D).sum(2).to(dk.dtype)
        dv = dv.reshape(B, Hkv, rep, S, D).sum(2).to(dv.dtype)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None):
    """(dq, dk, dv) for [B, H, S, D] q, [B, Hkv, S, D] k/v, the forward's
    o and lse, and the output cotangent do: the plain versions of the
    delta and the backward kernel, every output in q's dtype."""
    return _bwd(q, k, v, o, lse, do, causal, scale,
                flash_attention_bwd_delta_plain,
                flash_attention_bwd_kernel_plain)


def flash_attention_bwd_tiles(q, k, v, o, lse, do, causal=False,
                              scale=None):
    """(dq, dk, dv) as flash_attention_bwd_plain, with the kernel's tile
    order (flash_attention_bwd_kernel_tiles) in place of whole rows."""
    return _bwd(q, k, v, o, lse, do, causal, scale,
                flash_attention_bwd_delta_plain,
                flash_attention_bwd_kernel_tiles)


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """(dq, dk, dv) — see flash_attention_bwd_plain. A CPU tensor takes the
    plain versions; a CUDA tensor launches the delta kernel and the
    backward kernel or raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    return _bwd(q, k, v, o, lse, do, causal, scale,
                flash_attention_bwd_delta, flash_attention_bwd_kernel)


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
    if D not in HEAD_DIMS:
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
