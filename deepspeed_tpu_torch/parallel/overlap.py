"""Ring collectives over the data axis: ``ring_reduce_scatter`` and
``ring_all_gather`` (``deepspeed_tpu/parallel/overlap.py:119``, ``:147``)
and the mean all-reduce that ``bucketed_allreduce`` (``:196``) gives
replicated leaves.

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

import torch


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
