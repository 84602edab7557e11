"""Fused all-gather+matmul and matmul+reduce-scatter over ZeRO-3 resting
shards: the dispatch half of ``deepspeed_tpu/ops/pallas/fused_collective.py``.

``all_gather_matmul`` (:761) computes ``x @ W`` (or ``x @ W^T``) where W
rests as this rank's 1/n shard, the gather fused into the GEMM's tile
loads; ``matmul_reduce_scatter`` (:816) this rank's shard of the sum over
the ranks of ``lhs^T @ rhs``; ``collective_matmul`` (:894) pairs them as
``_collective_matmul_fn`` (:861) does: the forward gathers W through the
GEMM, the backward computes dx by the transposed all-gather+matmul from
the same resting shard and dW by matmul+reduce-scatter, cast to the
shard's dtype (a shard-shaped SUM over the ranks: the caller scales by
1/n for the mean).

The world is the config's ``mesh`` (``parallel/mesh.py``). The peers'
shards come from the symmetric heap on the card (the shard must rest
there) and over gloo on the CPU. ``backend``: "lax" is the plain ring
(the kernels' plain versions, in JAX's ``backend="lax"`` order), an
explicit choice as in JAX; "auto" and "fused" run the CUDA kernels
(``ops/cuda/fused_collective.py``) on the card and their plain versions
on the CPU. A shape the kernels do not take raises: nothing falls back
to the ring quietly, so JAX's TPU feasibility gates (VMEM budget, lane
alignment) have no counterpart. At n = 1 both ops are a plain product.
"""

import dataclasses
import threading
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.config.config import ROADMAP_STREAM
from deepspeed_tpu_torch.ops.cuda import fused_collective as kernels
from deepspeed_tpu_torch.parallel import overlap


@dataclasses.dataclass(frozen=True)
class CollectiveMatmulConfig:
    """Per-train-fn configuration (``fused_collective.py:87``); ``mesh``
    is the world the collectives run over. JAX's ``tile_m``,
    ``vmem_budget_bytes`` and ``interpret`` shape the TPU kernel's grid
    and VMEM and have no counterpart; ``min_shard_bytes`` is the engine's
    to read (``_select_fused_matmul_leaves``). ``hierarchy``, JAX's
    two-level ring split (``RingHierarchy`` :66), is not ported: any
    value but None raises where the config is used."""
    axis_size: int = 1
    backend: str = "auto"
    hierarchy: Any = None
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)


class _CtxState(threading.local):
    def __init__(self):
        self.stack = []


_ctx_state = _CtxState()


class gather_scope:
    """While entered, collective-matmul-aware dense layers
    (``models/gpt2.CollectiveDense``) take a shard-shaped kernel for a
    ZeRO-3 resting shard and feed it to ``collective_matmul``. The
    prefetch pipeline enters it around each layer's forward and
    recomputation. Re-entrant; the innermost wins."""

    def __init__(self, cfg: Optional[CollectiveMatmulConfig]):
        self.cfg = cfg

    def __enter__(self):
        _ctx_state.stack.append(self.cfg)
        return self

    def __exit__(self, *exc):
        _ctx_state.stack.pop()
        return False


def gather_ctx() -> Optional[CollectiveMatmulConfig]:
    """The active fused-gather config, or None outside a gather_scope."""
    stack = _ctx_state.stack
    return stack[-1] if stack else None


def infer_shard_dim(shard_shape, in_dim, features, axis_size):
    """Which dim of a [in_dim, features] weight a shard cuts: 0, 1, or
    None when ``shard_shape`` is the full shape. Raises on a shape that is
    neither."""
    shard_shape = tuple(int(s) for s in shard_shape)
    if shard_shape == (in_dim, features):
        return None
    if in_dim % axis_size == 0 and \
            shard_shape == (in_dim // axis_size, features):
        return 0
    if features % axis_size == 0 and \
            shard_shape == (in_dim, features // axis_size):
        return 1
    raise ValueError(
        f"kernel value of shape {shard_shape} is neither the full "
        f"({in_dim}, {features}) weight nor its 1/{axis_size} shard on "
        f"either dim")


def _resolve(cfg):
    cfg = cfg or CollectiveMatmulConfig()
    if cfg.backend not in ("auto", "fused", "lax"):
        raise ValueError(f"collective_matmul backend must be 'auto', "
                         f"'fused' or 'lax', got {cfg.backend!r}")
    if cfg.hierarchy is not None:
        raise NotImplementedError(
            f"collective_matmul over a two-level ring hierarchy is not "
            f"ported ({ROADMAP_STREAM})")
    return cfg, ("lax" if cfg.backend == "lax" else "fused")


def _world(cfg, n):
    mesh = cfg.mesh
    if mesh is None or mesh.size != n:
        raise ValueError(f"collective_matmul over {n} ranks needs the "
                         f"config's mesh of that size, got {mesh!r}")
    return mesh


def peer_shards(w_shard, mesh):
    """The n ranks' shards in rank order: the heap's peer views on the
    card, a gloo all-gather on the CPU."""
    if mesh.heap is not None:
        return mesh.heap.peer_views(w_shard)
    if w_shard.device.type != "cpu":
        raise ValueError("a shard on the card must rest in the symmetric "
                         "heap (parallel/symmetric_memory.py)")
    return mesh.all_gather(w_shard)


def _as_2d(x):
    return x.reshape(-1, x.shape[-1])


def all_gather_matmul(x, w_shard, *, shard_dim, axis_size=1,
                      transpose_w=False, cfg=None, out_dtype=None):
    """``x @ W_full`` (or ``x @ W_full^T``) with W resting as this rank's
    shard cut on ``shard_dim``; x [..., K] → [..., N], fp32 accumulation,
    the result in ``out_dtype`` (default x's)."""
    out_dtype = out_dtype or x.dtype
    n = int(axis_size)
    lead = x.shape[:-1]
    x2 = _as_2d(x).contiguous()
    if n == 1:
        w = w_shard.t() if transpose_w else w_shard
        if out_dtype == x.dtype == w.dtype:
            y = torch.matmul(x2, w)
        else:
            y = (x2.float() @ w.float()).to(out_dtype)
        return y.reshape(lead + (y.shape[-1],))
    cfg, backend = _resolve(cfg)
    mesh = _world(cfg, n)
    shards = peer_shards(w_shard.contiguous(), mesh)
    fn = kernels.ag_matmul if backend == "fused" else kernels.ag_matmul_plain
    y = fn(x2, shards, mesh.rank, shard_dim, transpose_w, out_dtype)
    return y.reshape(lead + (y.shape[-1],))


def matmul_reduce_scatter(lhs, rhs, *, shard_dim, axis_size=1, cfg=None,
                          out_dtype=None, shard=None):
    """This rank's shard of the sum over the ranks of ``lhs^T @ rhs``
    (lhs [..., K], rhs [..., N]): [K/n, N] (shard_dim 0) or [K, N/n]
    (shard_dim 1), SUMMED, not meaned, in ``out_dtype`` (default fp32).

    Inside an open ``overlap.ReduceScatterBatch`` (the ZeRO-3 backward's
    layer batch) the partials go into the batch's columns for ``shard``
    (the resting shard whose gradient this is) and the result comes back
    unfilled: the batch's close fills it, with the layer's other
    reduce-scatters, after one barrier. Outside a batch the exchange is
    its own: a slot, a barrier, a reduce."""
    n = int(axis_size)
    l2, r2 = _as_2d(lhs).contiguous(), _as_2d(rhs).contiguous()
    out_dtype = out_dtype or torch.float32
    if n == 1:
        return (l2.float().t() @ r2.float()).to(out_dtype)
    cfg, backend = _resolve(cfg)
    mesh = _world(cfg, n)
    K, N = l2.shape[1], r2.shape[1]
    shape = (K // n, N) if shard_dim == 0 else (K, N // n)
    batch = overlap.active_batch()
    if batch is not None:
        if shard is None:
            raise ValueError("matmul_reduce_scatter inside a reduce-scatter "
                             "batch needs the resting shard it reduces for")
        key = overlap.shard_key(shard)
        cols = batch.columns(key)
        if backend == "fused":
            kernels.mm_rs_partial(l2, r2, shard_dim, n, out=cols)
        else:
            cols.copy_(kernels.mm_rs_partial_plain(l2, r2, shard_dim, n))
        return batch.defer(key, shape, out_dtype)
    if mesh.heap is None:
        part = kernels.mm_rs_partial(l2, r2, shard_dim, n) \
            if backend == "fused" else \
            kernels.mm_rs_partial_plain(l2, r2, shard_dim, n)
        slots = mesh.all_gather(part)
    else:
        slot = mesh.heap.slot(K * N).view(n, K * N // n)
        if backend == "fused":
            kernels.mm_rs_partial(l2, r2, shard_dim, n, out=slot)
        else:
            slot.copy_(kernels.mm_rs_partial_plain(l2, r2, shard_dim, n))
        mesh.barrier()
        slots = mesh.heap.peer_views(slot)
    out = kernels.mm_rs_reduce(slots, mesh.rank) if backend == "fused" \
        else kernels.mm_rs_reduce_plain(slots, mesh.rank)
    return out.reshape(shape).to(out_dtype)


class _CollectiveMatmul(torch.autograd.Function):
    """Forward all-gather+matmul; backward dx by the transposed
    all-gather+matmul from the same resting shard and dW by
    matmul+reduce-scatter in the shard's dtype."""

    @staticmethod
    def forward(ctx, x, w_shard, shard_dim, axis_size, cfg):
        ctx.save_for_backward(x, w_shard)
        ctx.args = (shard_dim, axis_size, cfg)
        return all_gather_matmul(x, w_shard, shard_dim=shard_dim,
                                 axis_size=axis_size, cfg=cfg)

    @staticmethod
    def backward(ctx, dy):
        x, w_shard = ctx.saved_tensors
        shard_dim, axis_size, cfg = ctx.args
        dx = all_gather_matmul(dy, w_shard, shard_dim=shard_dim,
                               axis_size=axis_size, transpose_w=True,
                               cfg=cfg, out_dtype=x.dtype)
        # dW in the shard's dtype from the start: inside the layer's
        # reduce-scatter batch it is filled only at the batch's close, so
        # nothing (no cast) may read it before
        dw = matmul_reduce_scatter(x, dy, shard_dim=shard_dim,
                                   axis_size=axis_size, cfg=cfg,
                                   out_dtype=w_shard.dtype, shard=w_shard)
        return dx.reshape(x.shape), dw, None, None, None


def collective_matmul(x, w_shard, *, shard_dim, axis_size=1, cfg=None):
    """Differentiable ``x @ W_full`` over a ZeRO-3 resting shard (see the
    module docstring): dW comes back shard-shaped, summed over the
    ranks."""
    cfg = cfg or CollectiveMatmulConfig(axis_size=axis_size)
    return _CollectiveMatmul.apply(x, w_shard, int(shard_dim),
                                   int(axis_size), cfg)
