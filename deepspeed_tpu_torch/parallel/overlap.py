"""Ring collectives over the data axis: ``ring_reduce_scatter`` and
``ring_all_gather`` (``deepspeed_tpu/parallel/overlap.py:119``, ``:147``),
the mean all-reduce that ``bucketed_allreduce`` (``:196``) gives
replicated leaves, and ``ReduceScatterBatch``, which runs a ZeRO-3
layer's reduce-scatters as one exchange.

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
import threading

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
    all-reduced (the mean by default), unpacked in their own shapes:
    ``bucketed_allreduce`` with one bucket."""
    if not leaves or mesh.size == 1:
        return list(leaves)
    flat = torch.cat([g.float().reshape(-1) for g in leaves])
    red = all_reduce(flat, mesh, mean=mean)
    out, off = [], 0
    for g in leaves:
        out.append(red[off:off + g.numel()].reshape(g.shape))
        off += g.numel()
    return out


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
