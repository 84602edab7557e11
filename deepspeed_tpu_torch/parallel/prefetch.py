"""ZeRO-3's layer-wise parameter-gather prefetch pipeline, for the port.

Port of ``deepspeed_tpu/parallel/prefetch.py`` (its ``plan_from_specs``
:56 is in ``runtime/zero/partition.py``): ``LayerPlan`` (:75),
``build_layer_plan`` (:108), the chunk-major packing (:151-163),
``gather_leaf`` (:166), ``scatter_grad`` (:190), ``_gather_groups`` (:226),
``_unpack_layer_full`` (:245), ``_scatter_layer_grads`` (:262),
``make_prefetched_scan`` (:313) and ``make_gathered_param`` (:560).

A layer's sharded leaves pack into one flat buffer a dtype group (on the
card the engine lays them out contiguously in the symmetric heap, so the
packed buffer is a view, and the gather reads the peers' twins of it).
The forward runs the layers in order; layer i+1's buffer is gathered on
a side stream while layer i computes (on the CPU, over gloo, in turn),
and gathered parameters are dropped after their layer: two layers' full
parameters are live at a time. The backward (a ``torch.autograd.Function``)
runs in reverse: it re-gathers layer i-1 while it recomputes layer i
under ``enable_grad`` from the saved layer input (full remat, the same
memory shape as the reference's post-backward release), takes layer i's
gradients, and reduce-scatters the packed ones, one exchange a group.

``mode="fused_matmul"``: the ``fused_ids`` leaves skip the packed gather;
the body gets their resting shards inside ``gather_scope(fused_cfg)``, and
its collective-matmul-aware dense layers stream them through the fused
kernels, whose backward returns their gradients already reduce-scattered:
shard-shaped SUMS in the parameter's dtype. Packed leaves come back as
fp32 shard SUMS, replicated leaves LOCAL (the caller reduces them).
``mode="fused"`` (XLA's own schedule) and ``hier`` are not ported.
"""

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from deepspeed_tpu_torch.config.config import ROADMAP_STREAM
from deepspeed_tpu_torch.ops import fused_collective as fc
from deepspeed_tpu_torch.parallel import overlap


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Static packing plan for one layer: ``plan`` entries in per-layer
    coordinates ((dim, shard_size) or None); sharded leaves grouped by
    dtype into packed buffers; ``fused`` leaves stream through the fused
    kernels as resting shards instead."""
    plan: Tuple[Optional[Tuple[int, int]], ...]
    groups: Tuple[Tuple[Any, Tuple[int, ...]], ...]
    n: int
    fused: Tuple[int, ...] = ()

    @property
    def sharded_ids(self):
        return tuple(i for g in self.groups for i in g[1])


def _check_mode(mode):
    if mode == "fused":
        raise NotImplementedError(
            f"stage3_prefetch_gather 'fused' hands the gathers to XLA's "
            f"schedule, which has no counterpart here ({ROADMAP_STREAM})")
    if mode not in ("ring", "fused_matmul"):
        raise ValueError(f"mode must be 'ring', 'fused' or "
                         f"'fused_matmul', got {mode!r}")


def build_layer_plan(shard_leaves, plan, n, fused_ids=()):
    """``shard_leaves``: a rank's layer-stacked shards ([L, ...]; anything
    with ``shape`` and ``dtype``); ``plan``: entries in stacked
    coordinates, dim 0 (the layer) never cut. ``fused_ids`` skip the
    packed groups."""
    per_layer, groups = [], {}
    fused = tuple(sorted(fused_ids))
    for i, (leaf, entry) in enumerate(zip(shard_leaves, plan)):
        if entry is None:
            assert i not in fused, \
                f"fused leaf {i} is not sharded — engine selection bug"
            per_layer.append(None)
            continue
        d, sz = entry
        assert d >= 1, (
            f"layer-stacked leaf {i} sharded on its layer dim (shape "
            f"{tuple(leaf.shape)}); exclude dim 0 via "
            f"layer_stacked_prefixes")
        per_layer.append((d - 1, sz))
        if i not in fused:
            groups.setdefault(leaf.dtype, []).append(i)
    return LayerPlan(plan=tuple(per_layer),
                     groups=tuple((dt, tuple(ids))
                                  for dt, ids in groups.items()),
                     n=n, fused=fused)


# -- chunk-major leaf <-> flat packing ----------------------------------------

def _full_from_chunks(chunks, d):
    """[n, *shard_shape] (chunk j = rank j's slice of dim ``d``) → the full
    leaf, dim ``d`` of size n * shard."""
    full = chunks.movedim(0, d)
    shape = list(full.shape)
    shape[d:d + 2] = [shape[d] * shape[d + 1]]
    return full.reshape(shape)


def _chunks_from_full(full, d, n):
    shape = list(full.shape)
    shape[d:d + 1] = [n, shape[d] // n]
    return full.reshape(shape).movedim(d, 0)


def gather_leaf(shard, entry, mesh, mode="ring"):
    """One sharded leaf ((dim, size) entry) gathered to its full shape."""
    if entry is None or mesh.size == 1:
        return shard
    _check_mode(mode)
    d, _ = entry
    flat = overlap.ring_all_gather(shard.contiguous().reshape(-1), mesh)
    return _full_from_chunks(flat.reshape((mesh.size,) + tuple(shard.shape)),
                             d)


def scatter_grad(grad_full, entry, mesh, mode="ring"):
    """A full leaf's gradient reduce-scattered back to this rank's shard
    (fp32 SUM over the ranks): the transpose of ``gather_leaf``."""
    if entry is None or mesh.size == 1:
        return grad_full
    _check_mode(mode)
    d, _ = entry
    chunks = _chunks_from_full(grad_full.float(), d, mesh.size)
    return overlap.ring_reduce_scatter(chunks.reshape(-1), mesh).reshape(
        chunks.shape[1:])


def _pack(leaves):
    """The leaves' elements as one flat buffer: a view when they lie back
    to back in one storage (the heap's packed layout), a copy otherwise."""
    flat = [t.reshape(-1) for t in leaves]
    if len(flat) == 1:
        return flat[0]
    first = flat[0]
    total = sum(t.numel() for t in flat)
    ptr, ok = first.data_ptr(), all(t.is_contiguous() for t in leaves)
    for t in flat:
        ok = ok and t.data_ptr() == ptr and \
            t.untyped_storage().data_ptr() == first.untyped_storage().data_ptr()
        ptr += t.numel() * t.element_size()
    if ok:
        return first.as_strided((total,), (1,), first.storage_offset())
    return torch.cat(flat)


def _gather_groups(group_bufs, mesh):
    """Each group's packed shard [K_g] → gathered [n, K_g] (row j = rank
    j's shard): one exchange a group a layer."""
    return tuple(overlap.ring_all_gather(buf, mesh).reshape(mesh.size,
                                                           buf.numel())
                 for buf in group_bufs)


def _unpack_layer_full(gathered, shard_shapes, lp):
    """Each group's gathered [n, K_g] → the full per-layer leaves
    {id: tensor}."""
    out = {}
    for (_, ids), buf in zip(lp.groups, gathered):
        off = 0
        for i in ids:
            shape = tuple(shard_shapes[i])
            m = math.prod(shape or (1,))
            d, _ = lp.plan[i]
            out[i] = _full_from_chunks(
                buf[:, off:off + m].reshape((lp.n,) + shape), d)
            off += m
    return out


def _scatter_layer_grads(grads_by_id, shard_shapes, lp, mesh):
    """Full per-layer gradients → fp32 shard SUMS {id: tensor}, packed so
    that a layer costs one reduce-scatter a group."""
    out = {}
    for _, ids in lp.groups:
        parts = [_chunks_from_full(grads_by_id[i].float(), lp.plan[i][0],
                                   lp.n).reshape(lp.n, -1) for i in ids]
        flat = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        shard = overlap.ring_reduce_scatter(flat.reshape(-1), mesh)
        off = 0
        for i in ids:
            shape = tuple(shard_shapes[i])
            m = math.prod(shape or (1,))
            out[i] = shard[off:off + m].reshape(shape)
            off += m
    return out


class _Gathers:
    """Packed layer gathers, issued on a side stream on the card (the
    heap's peer views are read there while the main stream computes) and
    in turn on the CPU."""

    def __init__(self, layers, lp, mesh):
        self.layers, self.lp, self.mesh = layers, lp, mesh
        cuda = mesh.device.type == "cuda"
        self.side = torch.cuda.Stream(mesh.device) if cuda else None

    def start(self, i):
        bufs = tuple(_pack([self.layers[i][j] for j in ids])
                     for _, ids in self.lp.groups)
        if self.side is None:
            return _gather_groups(bufs, self.mesh), None
        self.side.wait_stream(torch.cuda.current_stream(self.mesh.device))
        with torch.cuda.stream(self.side):
            out = _gather_groups(bufs, self.mesh)
            done = torch.cuda.Event()
            done.record(self.side)
        return out, done

    def wait(self, started):
        gathered, done = started
        if done is not None:
            main = torch.cuda.current_stream(self.mesh.device)
            main.wait_event(done)
            for t in gathered:
                t.record_stream(main)
        return gathered


class _PrefetchedScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, spec, *flat):
        body, plan, mesh, mode, fused_ids, cfg, L, nleaf = spec
        layers = [flat[i * nleaf:(i + 1) * nleaf] for i in range(L)]
        shapes = [tuple(t.shape) for t in layers[0]]
        lp = build_layer_plan([_Stacked(L, t) for t in layers[0]], plan,
                              mesh.size, fused_ids)
        gathers = _Gathers(layers, lp, mesh)
        xs = []
        g_cur = gathers.start(0) if lp.groups else ((), None)
        for i in range(L):
            g_nxt = gathers.start(i + 1) if lp.groups and i + 1 < L \
                else ((), None)
            full = _unpack_layer_full(gathers.wait(g_cur), shapes, lp)
            lt = [full.get(j, layers[i][j]) for j in range(nleaf)]
            xs.append(x)
            with fc.gather_scope(cfg if lp.fused else None):
                x = body(x, lt)
            g_cur = g_nxt
        ctx.spec, ctx.lp, ctx.shapes = spec, lp, shapes
        ctx.save_for_backward(*xs, *flat)
        return x

    @staticmethod
    def backward(ctx, dy):
        body, plan, mesh, mode, fused_ids, cfg, L, nleaf = ctx.spec
        lp, shapes = ctx.lp, ctx.shapes
        saved = ctx.saved_tensors
        xs, flat = saved[:L], saved[L:]
        layers = [flat[i * nleaf:(i + 1) * nleaf] for i in range(L)]
        gathers = _Gathers(layers, lp, mesh)
        grads = [None] * len(flat)
        sharded = set(lp.sharded_ids)
        g_cur = gathers.start(L - 1) if lp.groups else ((), None)
        for i in reversed(range(L)):
            g_prev = gathers.start(i - 1) if lp.groups and i > 0 \
                else ((), None)
            full = _unpack_layer_full(gathers.wait(g_cur), shapes, lp)
            x_i = xs[i].detach().requires_grad_()
            lt = [full[j].detach().requires_grad_() if j in full
                  else layers[i][j].detach().requires_grad_()
                  for j in range(nleaf)]
            with torch.enable_grad(), \
                    fc.gather_scope(cfg if lp.fused else None):
                y = body(x_i, lt)
            d = torch.autograd.grad(y, [x_i] + lt, dy, allow_unused=True)
            dy = d[0]
            d_leaves = [torch.zeros_like(t) if g is None else g
                        for g, t in zip(d[1:], lt)]
            shards = _scatter_layer_grads(
                {j: d_leaves[j] for j in sharded}, shapes, lp, mesh)
            for j in range(nleaf):
                grads[i * nleaf + j] = shards.get(j, d_leaves[j])
            g_cur = g_prev
        return (dy, None, *grads)


class _Stacked:
    """A per-layer shard seen as its layer-stacked leaf ([L, ...])."""

    def __init__(self, L, t):
        self.shape = (L,) + tuple(t.shape)
        self.dtype = t.dtype


def make_prefetched_scan(body, plan, mesh, mode="ring", fused_ids=(),
                         fused_cfg=None, hier=None):
    """``scan_fn(x, layer_shards) -> y``: ``body(x, leaves)`` over the
    layers, ``layer_shards`` a list (one entry a layer) of the layer's
    leaves (this rank's shards, in one leaf order); ``plan`` aligned
    with that order in stacked coordinates. See the module docstring."""
    _check_mode(mode)
    if fused_ids and mode != "fused_matmul":
        raise ValueError("fused_ids requires mode='fused_matmul'")
    if hier is not None:
        raise NotImplementedError(f"the two-level hierarchy (and its "
                                  f"error-compensated compression) is not "
                                  f"ported ({ROADMAP_STREAM})")
    plan = tuple(tuple(e) if e is not None else None for e in plan)
    fused_ids = tuple(sorted(fused_ids))

    def scan_fn(x, layer_shards):
        L, nleaf = len(layer_shards), len(layer_shards[0])
        flat = [t for layer in layer_shards for t in layer]
        spec = (body, plan, mesh, mode, fused_ids, fused_cfg, L, nleaf)
        return _PrefetchedScan.apply(x, spec, *flat)
    return scan_fn


class _GatheredParam(torch.autograd.Function):

    @staticmethod
    def forward(ctx, shard, entry, mesh, mode):
        ctx.args = (entry, mesh, mode)
        return gather_leaf(shard, entry, mesh, mode)

    @staticmethod
    def backward(ctx, cot):
        entry, mesh, mode = ctx.args
        return scatter_grad(cot, entry, mesh, mode), None, None, None


def make_gathered_param(entry, mesh, mode="ring", hier=None):
    """``g(shard) -> full`` for one non-layer sharded leaf, whose backward
    reduce-scatters the cotangent (fp32 SUM over the ranks). Gathered once
    a step, like the reference's persistent parameters."""
    if hier is not None:
        raise NotImplementedError(f"the two-level hierarchy is not ported "
                                  f"({ROADMAP_STREAM})")
    _check_mode(mode)
    return lambda shard: _GatheredParam.apply(shard, entry, mesh, mode)
