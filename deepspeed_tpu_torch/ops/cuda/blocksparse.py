"""Block-sparse attention: the CUDA kernels (csrc/blocksparse.cu), their
plain PyTorch versions and the autograd Function that joins them.

Replaces ``deepspeed_tpu/ops/pallas/blocksparse.py:455``
``blocksparse_attention``: the forward ``_bs_fwd`` (:325, kernel :107)
and both passes of ``_bs_bwd`` (:374: dq :187, dk/dv :250), joined by
``BlockSparseAttentionFunction`` as ``jax.custom_vjp`` joins them at
:542-556. A static [H, nb, nb] layout becomes per-row tables (its active
k-blocks) and the tables of its transpose (per k-block column, the
q-blocks that attend to it), made once per layout and sequence length
and kept on the device. The kernels take bf16 [B·H, S, 64] with a block
of 16, 32, 64 or 128; a CPU tensor takes the plain versions, a CUDA
tensor launches the kernels or raises.
"""

import collections
import dataclasses
import math

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda import builder, first_order_only

NEG_INF = -1e30
POS_INF = 1e30
HEAD_DIM = 64
BLOCKS = (16, 32, 64, 128)
ROADMAP_BS = ("ROADMAP.md queue 2, item \"block-sparse attention: masks, "
              "other head dims and blocks, fp32\"")
# the plain versions gather the active blocks of this many bytes of rows
# at a time
PLAIN_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class LayoutTables:
    """A layout's tables on one device (``_layout_tables``,
    blocksparse.py:48, of the layout and of its transpose): ``counts``
    [TH, nb] and ``cols`` [TH, nb, max_nnz] give each q-block row's active
    k-blocks, ``counts_t``/``rows_t`` each k-block column's q-blocks,
    int32, padded with 0. TH is 1 when every head has the same layout
    (the shared-layout collapse of :487-494), else H; head h reads table
    h % TH."""
    counts: torch.Tensor
    cols: torch.Tensor
    counts_t: torch.Tensor
    rows_t: torch.Tensor
    block: int

    @property
    def heads(self):
        return self.counts.shape[0]

    @property
    def num_blocks(self):
        return self.counts.shape[1]


def _tables(layout):
    """[TH, nb, nb] 0/1 → (counts [TH, nb], cols [TH, nb, max(max_nnz, 1)])
    int32: each row's active columns in ascending order, then zeros."""
    active = np.asarray(layout) != 0
    counts = active.sum(axis=2).astype(np.int32)
    width = max(int(counts.max(initial=0)), 1)
    order = np.argsort(~active, axis=2, kind="stable")[:, :, :width]
    cols = np.where(np.arange(width) < counts[..., None], order, 0)
    return counts, cols.astype(np.int32)


_CACHE = collections.OrderedDict()
_CACHE_SIZE = 64


def layout_tables(layout, seq_len, block, heads, device):
    """The ``LayoutTables`` of ``layout`` ([1 or heads, >= nb, >= nb], cut
    to nb = seq_len // block) on ``device``, made once and cached per
    (layout object, seq_len, block, heads, device)."""
    key = (id(layout), int(seq_len), int(block), int(heads), str(device))
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is layout:
        _CACHE.move_to_end(key)
        return hit[1]
    nb = seq_len // block
    lay = np.asarray(layout)[:, :nb, :nb]
    if lay.ndim != 3 or lay.shape[0] not in (1, heads) \
            or lay.shape[1:] != (nb, nb):
        raise ValueError(f"layout {np.shape(layout)} does not cover {heads} "
                         f"heads of {nb} blocks of {block}")
    if lay.shape[0] > 1 and bool(np.all(lay == lay[:1])):
        lay = lay[:1]
    counts, cols = _tables(lay)
    counts_t, rows_t = _tables(lay.transpose(0, 2, 1))
    tables = LayoutTables(*(torch.from_numpy(t).to(device) for t in
                            (counts, cols, counts_t, rows_t)), int(block))
    _CACHE[key] = (layout, tables)
    while len(_CACHE) > _CACHE_SIZE:
        _CACHE.popitem(last=False)
    return tables


def _scale(scale, D):
    return float(scale) if scale is not None else 1.0 / math.sqrt(D)


def _chunks(BH, bytes_per_bh):
    step = max(1, PLAIN_CHUNK_BYTES // max(int(bytes_per_bh), 1))
    return [(b0, min(BH, b0 + step)) for b0 in range(0, BH, step)]


def _gather_blocks(x, index, block):
    """x [n, S, ...] and block indices [n, nb, m] → [n, nb, m·block, ...]:
    the rows of each listed block, in the list's order."""
    n, nb, m = index.shape
    rows = (index[..., None].long() * block
            + torch.arange(block, device=x.device)).reshape(n, -1)
    g = x[torch.arange(n, device=x.device)[:, None], rows]
    return g.reshape(n, nb, m * block, *x.shape[2:])


def _valid(counts, width, block):
    """[n, nb] counts → [n, nb, width·block]: which gathered rows belong
    to a listed block (the rest is the table's padding)."""
    j = torch.arange(width, device=counts.device)
    return (j < counts[..., None]).repeat_interleave(block, dim=-1)


def blocksparse_fwd_plain(q, k, v, tables, scale=None):
    """(o fp32 [BH, S, D], lse fp32 [BH, S]) of ``_bs_fwd_kernel`` in plain
    PyTorch, block by block from the tables: each q-block row's scores
    over its active k-blocks only, fp32 softmax, p rounded to v's dtype
    before the V product (as the kernel rounds it). A row with no active
    block gives o = 0 and lse = +1e30."""
    BH, S, D = q.shape
    scale = _scale(scale, D)
    block, nb = tables.block, tables.num_blocks
    width = tables.cols.shape[-1]
    o = torch.empty(BH, S, D, dtype=torch.float32, device=q.device)
    lse = torch.empty(BH, S, dtype=torch.float32, device=q.device)
    for b0, b1 in _chunks(BH, nb * width * block * (4 * D + 3 * block) * 4):
        th = torch.arange(b0, b1, device=q.device) % tables.heads
        cols, counts = tables.cols[th], tables.counts[th]
        kg = _gather_blocks(k[b0:b1], cols, block).float()
        vg = _gather_blocks(v[b0:b1], cols, block).float()
        valid = _valid(counts, width, block)[:, :, None, :]
        qb = q[b0:b1].reshape(-1, nb, block, D).float() * scale
        s = torch.matmul(qb, kg.transpose(-1, -2))
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        ob = torch.matmul(p.to(v.dtype).float(), vg) / l.clamp_min(1e-30)
        o[b0:b1] = torch.where(l > 0, ob, 0.0).reshape(-1, S, D)
        lse[b0:b1] = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                                 POS_INF).reshape(-1, S)
    return o, lse


def blocksparse_bwd_dq_plain(q, k, v, do, lse, delta, tables, scale=None):
    """dq of ``_bs_dq_kernel`` in plain PyTorch: p = exp(scale·q·k - lse)
    over each row's active k-blocks, ds = p·(do·v - delta) rounded to q's
    dtype, dq = scale·ds·k, in q's dtype."""
    BH, S, D = q.shape
    scale = _scale(scale, D)
    block, nb = tables.block, tables.num_blocks
    width = tables.cols.shape[-1]
    dq = torch.empty_like(q)
    for b0, b1 in _chunks(BH, nb * width * block * (4 * D + 4 * block) * 4):
        th = torch.arange(b0, b1, device=q.device) % tables.heads
        cols, counts = tables.cols[th], tables.counts[th]
        kg = _gather_blocks(k[b0:b1], cols, block).float()
        vg = _gather_blocks(v[b0:b1], cols, block).float()
        valid = _valid(counts, width, block)[:, :, None, :]
        qb = q[b0:b1].reshape(-1, nb, block, D).float() * scale
        dob = do[b0:b1].reshape(-1, nb, block, D).float()
        s = torch.matmul(qb, kg.transpose(-1, -2))
        lb = lse[b0:b1].reshape(-1, nb, block, 1)
        p = torch.where(valid, torch.exp(s - lb), 0.0)
        dp = torch.matmul(dob, vg.transpose(-1, -2))
        ds = p * (dp - delta[b0:b1].reshape(-1, nb, block, 1))
        dqb = torch.matmul(ds.to(q.dtype).float(), kg) * scale
        dq[b0:b1] = dqb.reshape(-1, S, D).to(q.dtype)
    return dq


def blocksparse_bwd_dkv_plain(q, k, v, do, lse, delta, tables, scale=None):
    """(dk, dv) fp32 of ``_bs_dkv_kernel`` in plain PyTorch, per k-block
    column over the q-blocks of the transposed tables: dv = pᵀ·do, dk =
    scale·dsᵀ·q, p and ds rounded to q's dtype before their products."""
    BH, S, D = q.shape
    scale = _scale(scale, D)
    block, nb = tables.block, tables.num_blocks
    width = tables.rows_t.shape[-1]
    dk = torch.empty(BH, S, D, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for b0, b1 in _chunks(BH, nb * width * block * (4 * D + 4 * block) * 4):
        th = torch.arange(b0, b1, device=q.device) % tables.heads
        rows, counts = tables.rows_t[th], tables.counts_t[th]
        qg = _gather_blocks(q[b0:b1], rows, block).float()
        dog = _gather_blocks(do[b0:b1], rows, block).float()
        lg = _gather_blocks(lse[b0:b1], rows, block)[..., None]
        dg = _gather_blocks(delta[b0:b1], rows, block)[..., None]
        valid = _valid(counts, width, block)[..., None]
        kb = k[b0:b1].reshape(-1, nb, block, D).float()
        vb = v[b0:b1].reshape(-1, nb, block, D).float()
        s = torch.matmul(qg * scale, kb.transpose(-1, -2))
        p = torch.where(valid, torch.exp(s - lg), 0.0)
        dvb = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), dog)
        dp = torch.matmul(dog, vb.transpose(-1, -2))
        ds = p * (dp - dg)
        dkb = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                           qg) * scale
        dk[b0:b1] = dkb.reshape(-1, S, D)
        dv[b0:b1] = dvb.reshape(-1, S, D)
    return dk, dv


def _check(name, tables, **tensors):
    q = tensors["q"]
    BH, S, D = q.shape
    for t_name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {t_name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        want = (BH, S) if t_name in ("lse", "delta") else (BH, S, D)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {t_name} {tuple(t.shape)}, want "
                             f"{want}")
        dtype = torch.float32 if t_name in ("lse", "delta") \
            else torch.bfloat16
        if t.dtype != dtype:
            raise NotImplementedError(
                f"{name}: the CUDA kernel takes {dtype} {t_name}, got "
                f"{t.dtype} ({ROADMAP_BS})")
    if D != HEAD_DIM:
        raise NotImplementedError(f"{name}: the CUDA kernel takes head dim "
                                  f"{HEAD_DIM}, got {D} ({ROADMAP_BS})")
    if tables.block not in BLOCKS or S % tables.block:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes a block of {BLOCKS} that divides "
            f"S, got block {tables.block} at S {S} ({ROADMAP_BS})")
    if BH % tables.heads or tables.num_blocks != S // tables.block:
        raise ValueError(f"{name}: tables of {tables.heads} heads x "
                         f"{tables.num_blocks} blocks for [{BH}, {S}]")
    for t in (tables.counts, tables.cols, tables.counts_t, tables.rows_t):
        if t.device != q.device or t.dtype != torch.int32:
            raise ValueError(f"{name}: layout tables must be int32 on "
                             f"{q.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(name, q):
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return False


def blocksparse_fwd(q, k, v, tables, scale=None):
    """(o fp32, lse fp32) — see blocksparse_fwd_plain. On CUDA: bf16,
    contiguous [B·H, S, 64]."""
    if _on_cpu("blocksparse_fwd", q):
        return blocksparse_fwd_plain(q, k, v, tables, scale)
    _check("blocksparse_fwd", tables, q=q, k=k, v=v)
    BH, S, D = q.shape
    o = torch.empty(BH, S, D, dtype=torch.float32, device=q.device)
    lse = torch.empty(BH, S, dtype=torch.float32, device=q.device)
    if BH == 0 or S == 0:
        return o, lse
    builder.kernels().call(
        "dstpu_bs_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        tables.counts.data_ptr(), tables.cols.data_ptr(), o.data_ptr(),
        lse.data_ptr(), BH, tables.heads, S, tables.block,
        tables.cols.shape[-1], _scale(scale, D), _stream(q))
    builder.launches["blocksparse_fwd"] += 1
    return o, lse


def blocksparse_bwd_dq(q, k, v, do, lse, delta, tables, scale=None):
    """dq in q's dtype — see blocksparse_bwd_dq_plain. On CUDA: bf16 q, k,
    v, do and fp32 [B·H, S] lse and delta."""
    if _on_cpu("blocksparse_bwd_dq", q):
        return blocksparse_bwd_dq_plain(q, k, v, do, lse, delta, tables,
                                        scale)
    _check("blocksparse_bwd_dq", tables, q=q, k=k, v=v, do=do, lse=lse,
           delta=delta)
    BH, S, D = q.shape
    dq = torch.empty_like(q)
    if BH == 0 or S == 0:
        return dq
    builder.kernels().call(
        "dstpu_bs_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        tables.counts.data_ptr(), tables.cols.data_ptr(), dq.data_ptr(), BH,
        tables.heads, S, tables.block, tables.cols.shape[-1],
        _scale(scale, D), _stream(q))
    builder.launches["blocksparse_bwd_dq"] += 1
    return dq


def blocksparse_bwd_dkv(q, k, v, do, lse, delta, tables, scale=None):
    """(dk, dv) fp32 — see blocksparse_bwd_dkv_plain. On CUDA: as
    blocksparse_bwd_dq."""
    if _on_cpu("blocksparse_bwd_dkv", q):
        return blocksparse_bwd_dkv_plain(q, k, v, do, lse, delta, tables,
                                         scale)
    _check("blocksparse_bwd_dkv", tables, q=q, k=k, v=v, do=do, lse=lse,
           delta=delta)
    BH, S, D = q.shape
    dk = torch.empty(BH, S, D, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if BH == 0 or S == 0:
        return dk, dv
    builder.kernels().call(
        "dstpu_bs_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        tables.counts_t.data_ptr(), tables.rows_t.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), BH, tables.heads, S, tables.block,
        tables.rows_t.shape[-1], _scale(scale, D), _stream(q))
    builder.launches["blocksparse_bwd_dkv"] += 1
    return dk, dv


class BlockSparseAttentionFunction(torch.autograd.Function):
    """[B·H, S, D] block-sparse attention with its recompute backward:
    the forward saves (q, k, v, o fp32, lse); the backward takes delta =
    rowsum(do·o) in fp32 (blocksparse.py:381) and runs the dq and dk/dv
    passes. Its output is fp32; the caller casts it. Like
    ``FlashAttentionFunction`` it is once differentiable: a second
    derivative through it raises."""

    @staticmethod
    def forward(ctx, q, k, v, tables, scale):
        o, lse = blocksparse_fwd(q, k, v, tables, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.scale = tables, scale
        return o

    @staticmethod
    @first_order_only
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o).sum(-1)
        # the cotangent of o's cast to q's dtype: exact in that dtype
        do = do.to(q.dtype).contiguous()
        dq = blocksparse_bwd_dq(q, k, v, do, lse, delta, ctx.tables,
                                ctx.scale)
        dk, dv = blocksparse_bwd_dkv(q, k, v, do, lse, delta, ctx.tables,
                                     ctx.scale)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None


def blocksparse_attention(q, k, v, layout, block, scale=None):
    """[B, H, S, D] attention restricted to ``layout`` [H or 1, S//block,
    S//block], differentiable, in q's dtype: the fp32 output of
    ``BlockSparseAttentionFunction`` is cast outside it, so backward's
    delta reads the unrounded o (blocksparse.py:557-559)."""
    B, H, S, D = q.shape
    if S % block:
        raise NotImplementedError(
            f"blocksparse_attention: S {S} is not a multiple of the layout "
            f"block {block} ({ROADMAP_BS})")
    tables = layout_tables(layout, S, block, H, q.device)
    qf, kf, vf = (t.reshape(B * H, S, D).contiguous() for t in (q, k, v))
    o = BlockSparseAttentionFunction.apply(qf, kf, vf, tables,
                                           _scale(scale, D))
    return o.to(q.dtype).reshape(B, H, S, D)
