"""Ring collectives over the data axis: ``ring_reduce_scatter`` and
``ring_all_gather`` (``deepspeed_tpu/parallel/overlap.py:119``, ``:147``),
the bucket stream of ZeRO stages 0-2 (``plan_buckets`` :67,
``bucketed_allreduce`` :196, in its ring form only) and the all-gather
of the updated slices after their sharded update, the mean all-reduce
of ZeRO-3's replicated leaves, and ``ReduceScatterBatch``, which runs a
ZeRO-3 layer's reduce-scatters as one exchange.

JAX's schedule: chunk k of a buffer lands on rank k, and its
reduce-scatter sum starts with the partial of rank k+1 and ends with rank
k's own (each ring hop adds the local chunk to what arrived). The port
keeps that order, so its sums round as JAX's do, but not the hops: every
rank hands its buffer over whole and then reads the chunks it needs. On
the card the buffer goes into an exchange slot of the symmetric heap
(a tensor already in the heap, a resting shard, is read where it lies),
a barrier orders the writes before the reads, and the peers' views are
read with plain torch ops; on the CPU the buffers travel over gloo.
"""

import contextlib
import dataclasses
import math
import threading
from typing import Tuple

import torch

from deepspeed_tpu_torch.ops.cuda import fused_collective as kernels

# a batch's entries start at multiples of this many elements (256 bytes
# of fp32), so that every entry is 16-byte aligned for the kernels
BATCH_ALIGN = 64


def _exchange(buf, mesh):
    """Every rank's ``buf`` in rank order: the peers' heap views on the card
    (through a slot and a barrier unless ``buf`` already rests in the
    heap), a gloo all-gather on the CPU."""
    heap = mesh.heap
    if heap is None:
        return mesh.all_gather(buf)
    if not (heap.contains(buf) and buf.is_contiguous()):
        slot = heap.slot(buf.numel(), buf.dtype).view(buf.shape)
        slot.copy_(buf)
        mesh.barrier()
        buf = slot
    return heap.peer_views(buf)


def ring_order_sum(parts, k):
    """parts[(k+1) % n] + parts[(k+2) % n] + ... + parts[k], left to right:
    the ring's order for chunk k."""
    n = len(parts)
    acc = parts[(k + 1) % n].clone()
    for j in range(2, n + 1):
        acc = acc + parts[(k + j) % n]
    return acc


def ring_reduce_scatter(buf, mesh):
    """[n*c] local buffer → [c]: this rank's chunk summed over the ranks,
    in the ring's order."""
    n = mesh.size
    if buf.numel() % n:
        raise ValueError(f"reduce-scatter of {buf.numel()} elements over "
                         f"{n} ranks")
    if n == 1:
        return buf.reshape(-1)
    flat = buf.reshape(n, -1)
    parts = _exchange(flat, mesh)
    return ring_order_sum([p[mesh.rank] for p in parts], mesh.rank)


def ring_all_gather(shard, mesh):
    """[c] shard (this rank owns chunk ``rank``) → [n*c], chunks in rank
    order."""
    if mesh.size == 1:
        return shard.reshape(-1)
    return torch.cat([p.reshape(-1) for p in _exchange(shard, mesh)])


def all_reduce(buf, mesh, mean=False):
    """``buf`` summed over the ranks (in rank order, so every rank holds
    the same bits), or its mean."""
    if mesh.size == 1:
        return buf
    parts = _exchange(buf.contiguous(), mesh)
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p
    return acc * (1.0 / mesh.size) if mean else acc


def allreduce_leaves(leaves, mesh, mean=True):
    """Gradients of replicated leaves, packed into one fp32 buffer,
    all-reduced in rank order (the mean by default), unpacked in their
    own shapes."""
    if not leaves or mesh.size == 1:
        return list(leaves)
    flat = torch.cat([g.float().reshape(-1) for g in leaves])
    red = all_reduce(flat, mesh, mean=mean)
    out, off = [], 0
    for g in leaves:
        out.append(red[off:off + g.numel()].reshape(g.shape))
        off += g.numel()
    return out


# -- the bucket stream of ZeRO stages 0-2 -------------------------------------

@dataclasses.dataclass(frozen=True)
class Bucket:
    """A run of whole leaves exchanged together: ``leaf_ids`` index the
    leaf list, ``sizes`` are their element counts, ``padded`` the
    exchange length (the total rounded up to a multiple of the ranks;
    the padding is zeros and reaches no leaf)."""
    leaf_ids: Tuple[int, ...]
    sizes: Tuple[int, ...]
    padded: int

    @property
    def numel(self):
        return int(sum(self.sizes))


def plan_buckets(shapes, bucket_elems, axis_size):
    """Greedy whole-leaf packing of ``shapes`` (in order) into buckets of
    about ``bucket_elems`` elements: a bucket closes when the next leaf
    would take it past the budget, so a leaf larger than the budget gets
    a bucket of its own, and the last bucket holds what is left."""
    bucket_elems = max(int(bucket_elems), 1)
    buckets, ids, sizes, acc = [], [], [], 0
    for i, shape in enumerate(shapes):
        n = math.prod(tuple(shape) or (1,))
        if ids and acc + n > bucket_elems:
            buckets.append(_close_bucket(ids, sizes, axis_size))
            ids, sizes, acc = [], [], 0
        ids.append(i)
        sizes.append(n)
        acc += n
    if ids:
        buckets.append(_close_bucket(ids, sizes, axis_size))
    return buckets


def _close_bucket(ids, sizes, axis_size):
    total = int(sum(sizes))
    padded = -(-total // axis_size) * axis_size
    return Bucket(tuple(ids), tuple(sizes), padded)


def _pack_bucket(leaves, bucket, out=None):
    """The bucket's leaves flattened into one fp32 buffer of ``padded``
    elements (``out``, or a new tensor), the tail zeroed."""
    if out is None:
        out = torch.empty(bucket.padded, dtype=torch.float32,
                          device=leaves[bucket.leaf_ids[0]].device)
    off = 0
    for i, sz in zip(bucket.leaf_ids, bucket.sizes):
        out[off:off + sz].copy_(leaves[i].reshape(-1))
        off += sz
    out[off:].zero_()
    return out


def _unpack_bucket(flat, metas, bucket, out, dtype=None):
    """Each leaf's elements of ``flat``, in the leaf's shape and dtype
    (``metas[i]``: (shape, dtype)), or in ``dtype``."""
    off = 0
    for i, sz in zip(bucket.leaf_ids, bucket.sizes):
        shape, leaf_dtype = metas[i]
        out[i] = flat[off:off + sz].view(shape).to(dtype or leaf_dtype)
        off += sz


def _bucket_region(leaves, bucket, mesh):
    """This rank's bucket as an [n, padded / n] fp32 region: a heap slot
    on the card (written, then a barrier, so the peers may read it), a
    tensor on the CPU."""
    n = mesh.size
    if mesh.heap is None:
        return _pack_bucket(leaves, bucket).view(n, -1)
    region = mesh.heap.slot(bucket.padded).view(n, -1)
    _pack_bucket(leaves, bucket, region.view(-1))
    mesh.barrier()
    return region


def _bucket_reduce_scatter(region, mesh):
    """This rank's chunk of the bucket, summed over the ranks in the
    ring's order: one ``mm_rs_reduce`` launch over the peers' views of
    their regions on the card, its plain version over the regions
    gathered by gloo on the CPU."""
    if mesh.heap is None:
        parts = mesh.all_gather(region)
    else:
        parts = mesh.heap.peer_views(region)
    return kernels.mm_rs_reduce(parts, mesh.rank)


def _bucket_all_gather(region, chunk, mesh):
    """The reduced chunks of every rank in rank order, [padded] fp32. On
    the card the chunk goes into row ``rank`` of this rank's region,
    which no peer reads during the reduce (rank c reads row c of every
    region), then a barrier, then each rank's row of its own region is
    read; the next write of this slot comes two exchanges later, after
    a barrier every peer's reads precede."""
    if mesh.heap is None:
        return torch.cat(mesh.all_gather(chunk))
    region[mesh.rank].copy_(chunk)
    mesh.barrier()
    views = mesh.heap.peer_views(region)
    return torch.cat([views[j][j] for j in range(mesh.size)])


def bucket_stream(leaves, mesh, buckets, mean=True, dtype=None,
                  consume=False):
    """The bucket exchange one bucket at a time: yields (bucket, {leaf
    id: the reduced leaf}) in plan order (see ``bucketed_allreduce``),
    each leaf in its dtype or in ``dtype`` (the engine's fp32, as JAX's
    leaves are after its accumulation). With ``consume`` each bucket's
    entries of ``leaves`` are set to None once packed, so the local
    gradients go as the stream goes; a reduced leaf is a view of its
    bucket's buffer, which lives while a view does."""
    n = mesh.size
    metas = [(t.shape, t.dtype) for t in leaves]
    for bucket in buckets:
        if n == 1:
            yield bucket, {i: leaves[i].to(dtype or leaves[i].dtype)
                           for i in bucket.leaf_ids}
            continue
        region = _bucket_region(leaves, bucket, mesh)
        if consume:
            for i in bucket.leaf_ids:
                leaves[i] = None
        chunk = _bucket_reduce_scatter(region, mesh)
        flat = _bucket_all_gather(region, chunk, mesh)
        if mean:
            flat.mul_(1.0 / n)
        out = {}
        _unpack_bucket(flat, metas, bucket, out, dtype)
        yield bucket, out


def bucketed_allreduce(leaves, mesh, bucket_elems, mean=True, buckets=None):
    """The leaves (each rank's local gradients) summed over the ranks, or
    their mean, as a stream of bucket exchanges (``:196``'s ring mode):
    each bucket packed into fp32, reduce-scattered in the ring's order
    and all-gathered, then times 1/n, and unpacked into each leaf's shape
    and dtype. ``buckets``: the plan, when the
    caller keeps it (default ``plan_buckets`` of the leaves). Returns the
    list of reduced leaves."""
    if not leaves or mesh.size == 1:
        return list(leaves)
    if buckets is None:
        buckets = plan_buckets([t.shape for t in leaves], bucket_elems,
                               mesh.size)
    out = [None] * len(leaves)
    for _, reduced in bucket_stream(leaves, mesh, buckets, mean):
        for i, t in reduced.items():
            out[i] = t
    return out


def all_gather_slices(leaves, plan, mesh, buckets):
    """After a sharded update: every leaf ``i`` with ``plan[i] = (dim,
    size)`` holds this rank's updated slice ``[rank * size, (rank + 1) *
    size)`` on ``dim``; fill the other ranks' slices from theirs, in
    place (JAX's tiled ``all_gather`` of the slices). One exchange a
    bucket of ``buckets`` (the gradient plan's grouping of the leaves),
    the slices packed in leaf order; leaves with no plan entry are
    whole on every rank and not exchanged."""
    n, rank = mesh.size, mesh.rank
    if n == 1:
        return leaves
    for bucket in buckets:
        ids = [i for i in bucket.leaf_ids if plan[i] is not None]
        if not ids:
            continue
        own = [leaves[i].narrow(plan[i][0], rank * plan[i][1], plan[i][1])
               for i in ids]
        total = sum(t.numel() for t in own)
        dtype = own[0].dtype
        if mesh.heap is None:
            buf = torch.cat([t.reshape(-1) for t in own])
            parts = mesh.all_gather(buf)
        else:
            buf = mesh.heap.slot(total, dtype)
            off = 0
            for t in own:
                buf[off:off + t.numel()].view(t.shape).copy_(t)
                off += t.numel()
            mesh.barrier()
            parts = mesh.heap.peer_views(buf)
        for j, part in enumerate(parts):
            if j == rank:
                continue
            off = 0
            for i, t in zip(ids, own):
                d, size = plan[i]
                leaves[i].narrow(d, j * size, size).copy_(
                    part[off:off + t.numel()].view(t.shape))
                off += t.numel()
    return leaves


# -- a layer's reduce-scatters as one exchange ---------------------------------

def batch_run(numels):
    """The length of a batch's region row for entries of ``numels``
    elements: each entry starts at a multiple of ``BATCH_ALIGN``."""
    return sum(-(-int(m) // BATCH_ALIGN) * BATCH_ALIGN for m in numels)


def shard_key(shard):
    """A batch's key for the gradient of a resting shard: its address
    (the same for the shard and every no-op cast or alias of it)."""
    return ("shard", shard.data_ptr())


class _Batches(threading.local):
    def __init__(self):
        self.stack = []


_batches = _Batches()


def active_batch():
    """The innermost open ``ReduceScatterBatch``, or None."""
    return _batches.stack[-1] if _batches.stack else None


class ReduceScatterBatch:
    """A ZeRO-3 layer's reduce-scatters as one exchange: one barrier and
    one ``mm_rs_reduce`` launch a layer, where each reduce-scatter took a
    barrier and a launch of its own.

    ``sizes`` ({key: numel}, in layout order) lays out a region [n, run]:
    entry k holds columns [off_k, off_k + numel_k) of every row, and row c
    holds what this rank sends to rank c (the n chunks of a partial lie a
    row apart). On the card the region is one exchange slot of the heap,
    so the two slots alternate layer by layer, as exchanges do: the
    barrier before layer i-1's reduce synchronizes every rank's device
    first, so every peer has finished reading layer i's slot before
    layer i-2 writes it again. Nothing else may take a slot between the
    batch's open and its close. On the CPU the region is a tensor and the
    close gathers it over gloo. Writers fill ``columns(key)`` and take
    ``defer(key, ...)``, an output not yet filled; ``close`` reduces row
    ``rank`` of every rank's region in the ring's order
    (``ring_order_sum``) into the deferred outputs, each in its own dtype.
    ``plain`` reduces with the plain version (the collective matmul's
    "lax" backend). Nothing may read a deferred output before the
    close."""

    def __init__(self, mesh, sizes, plain=False):
        self.mesh, self.plain = mesh, plain
        self.entries, off = {}, 0
        for key, m in sizes.items():
            self.entries[key] = (off, int(m))
            off += batch_run([m])
        self.run = off
        n = mesh.size
        if mesh.heap is not None:
            self.region = mesh.heap.slot(n * self.run).view(n, self.run)
        else:
            self.region = torch.zeros(n, self.run, device=mesh.device)
        self.outs = {}

    def _entry(self, key):
        if key not in self.entries:
            raise KeyError(f"the layer's reduce-scatter batch has no entry "
                           f"{key!r}: its layout names every leaf it takes")
        return self.entries[key]

    def columns(self, key):
        """Entry ``key``'s [n, numel] fp32 columns of the local region:
        row c is this rank's part of rank c's chunk."""
        off, m = self._entry(key)
        return self.region[:, off:off + m]

    def defer(self, key, shape, dtype=torch.float32):
        """Entry ``key``'s reduced chunk, in ``dtype`` and ``shape``: a
        tensor the close fills."""
        off, m = self._entry(key)
        if key in self.outs:
            raise RuntimeError(f"batch entry {key!r} deferred twice")
        out = torch.empty(shape, dtype=dtype, device=self.mesh.device)
        if out.numel() != m:
            raise ValueError(f"batch entry {key!r} holds {m} elements, not "
                             f"{tuple(shape)}")
        self.outs[key] = out
        return out

    def check_returned(self, grads):
        """``grads``: {key: the gradient autograd returned for it}. Each
        deferred output must be the very tensor returned: anything else
        means autograd summed or cast it, reading it unfilled."""
        for key, out in self.outs.items():
            if grads.get(key) is not out:
                raise RuntimeError(
                    f"the deferred reduce-scatter output {key!r} is not the "
                    f"gradient autograd returned: it was summed or cast "
                    f"before the batch filled it (each streamed shard must "
                    f"feed one collective matmul, in its own dtype)")

    def close(self):
        """One exchange (a barrier and the peers' views on the card, a gloo
        all-gather on the CPU) and one reduce into every deferred
        output."""
        if not self.outs:
            return
        mesh = self.mesh
        if mesh.heap is None:
            parts = mesh.all_gather(self.region)
        else:
            mesh.barrier()
            parts = mesh.heap.peer_views(self.region)
        table = sorted(((self.entries[k][0], t) for k, t in self.outs.items()),
                       key=lambda e: e[0])
        if self.plain:
            kernels.mm_rs_reduce_fill(
                kernels.mm_rs_reduce_plain(parts, mesh.rank), table)
        else:
            kernels.mm_rs_reduce(parts, mesh.rank, outs=table)


@contextlib.contextmanager
def reduce_scatter_batch(mesh, sizes, plain=False):
    """Open a ``ReduceScatterBatch`` for the block; close it (the exchange
    and the reduce) when the block ends without an exception."""
    batch = ReduceScatterBatch(mesh, sizes, plain)
    _batches.stack.append(batch)
    try:
        yield batch
    finally:
        _batches.stack.pop()
    batch.close()
