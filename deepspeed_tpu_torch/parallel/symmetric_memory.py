"""The symmetric heap: one ``cudaMalloc``'d region a rank, mapped by every
peer through CUDA IPC. It stands in for the JAX package's in-kernel
remote copies (``pltpu.make_async_remote_copy`` in
``ops/pallas/fused_collective.py``): a rank's resting ZeRO-3 shards and
its exchange slots live here, and a peer reads them through its own
mapping, with plain torch ops (``overlap.py``) or by a kernel handed the
table of the n ranks' pointers (``ops/cuda/fused_collective.py``). That
is what a symmetric-memory kernel does over NVLink on a node with a card
a rank; the ranks may also share one card.

Every rank lays its heap out alike (the same named regions at the same
offsets, then two exchange slots), so a tensor inside the local heap has
a twin at the same offset in every peer's: ``peer_views`` returns the n
twins in rank order. The heap comes from the port's C library
(``csrc/fused_collective.cu``), not from PyTorch's caching allocator,
whose sub-allocations (and expandable segments) do not share cleanly
through IPC; ``cudaIpcOpenMemHandle`` refuses a process's own handle, so
a rank keeps its own pointer. The IPC handles travel over gloo.

Ordering is the caller's, by ``Mesh.barrier()`` (the device synchronized,
then a gloo barrier): what a rank writes before a barrier its peers may
read after it. No kernel waits on a flag another process writes. The two
slots alternate call by call, so a slot is written again only after the
barrier of the call in between, by which time every peer's reads of it
have finished. ``close`` tears down in order: a barrier (no peer still
reads), then the peers' mappings closed, then the heap freed.
"""

import ctypes

import torch

ALIGN = 256
IPC_HANDLE_BYTES = 64        # CUDA_IPC_HANDLE_SIZE


class _DeviceBytes:
    """``__cuda_array_interface__`` of ``nbytes`` bytes at ``ptr``: lets
    ``torch.as_tensor`` view memory it did not allocate."""

    def __init__(self, ptr, nbytes):
        self.__cuda_array_interface__ = {
            "shape": (int(nbytes),), "typestr": "|u1",
            "data": (int(ptr), False), "version": 2, "strides": None}


def _align(n):
    return -(-int(n) // ALIGN) * ALIGN


def _nbytes(shape, dtype):
    numel = 1
    for s in shape:
        numel *= int(s)
    return numel * torch.empty((), dtype=dtype).element_size()


def _layout(regions, slot_bytes):
    """{name: byte offset} of ``regions`` ({name: (shape, dtype)}, laid
    out in order, each aligned to 256 bytes), the slots' offset and the
    heap's size: regions, then two slots of ``slot_bytes``."""
    offsets, off = {}, 0
    for name, (shape, dtype) in regions.items():
        offsets[name] = off
        off += _align(_nbytes(shape, dtype))
    slot_off = off
    return offsets, slot_off, slot_off + 2 * _align(slot_bytes)


class SymmetricHeap:
    """See the module docstring. ``regions``: {name: (shape, dtype)};
    ``slot_bytes``: the largest exchange one slot must hold. Collective:
    every rank of ``mesh`` makes it with the same arguments."""

    def __init__(self, mesh, regions, slot_bytes):
        from deepspeed_tpu_torch.ops.cuda import builder
        if mesh.device.type != "cuda":
            raise ValueError("the symmetric heap lives on the card; the "
                             "CPU's collectives run over gloo")
        self.mesh = mesh
        self.regions = dict(regions)
        self.slot_bytes = _align(slot_bytes)
        self.offsets, self.slot_off, self.nbytes = _layout(
            self.regions, slot_bytes)
        self._lib = builder.kernels()
        self._dev = mesh.device.index if mesh.device.index is not None \
            else torch.cuda.current_device()
        ptr = ctypes.c_void_p()
        self._lib.call("dstpu_heap_alloc", self._dev, self.nbytes // ALIGN,
                       ctypes.addressof(ptr))
        self._own = ptr.value
        handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        self._lib.call("dstpu_ipc_get_handle", self._own, handle,
                       IPC_HANDLE_BYTES)
        handles = mesh.all_gather(torch.frombuffer(
            bytearray(handle.raw), dtype=torch.uint8))
        self._bases, self._opened = [], []
        for r, h in enumerate(handles):
            if r == mesh.rank:
                self._bases.append(self._own)
                continue
            peer = ctypes.c_void_p()
            self._lib.call("dstpu_ipc_open", self._dev,
                           ctypes.create_string_buffer(
                               bytes(h.tolist()), IPC_HANDLE_BYTES),
                           ctypes.addressof(peer))
            self._bases.append(peer.value)
            self._opened.append(peer.value)
        # the peers' heaps, read through views of these; the local regions
        # and slots each get a tensor (a storage) of their own, so that
        # writing a slot does not bump the version counter that autograd
        # checks on a saved shard
        dev = mesh.device
        self._bytes = [torch.as_tensor(_DeviceBytes(b, self.nbytes),
                                       device=dev) for b in self._bases]
        self._local = {
            name: torch.as_tensor(_DeviceBytes(self._own + off, _nbytes(
                *self.regions[name])), device=dev).view(
                    self.regions[name][1]).view(self.regions[name][0])
            for name, off in self.offsets.items()}
        self._slots = [torch.as_tensor(_DeviceBytes(
            self._own + self.slot_off + i * self.slot_bytes,
            self.slot_bytes), device=dev) for i in range(2)]
        self._parity = 0
        mesh.heap = self
        mesh.barrier()

    def tensor(self, name):
        """The local view of region ``name``."""
        return self._local[name]

    def contains(self, t):
        off = t.data_ptr() - self._own
        return t.device == self.mesh.device and 0 <= off and \
            off + t.numel() * t.element_size() <= self.nbytes

    def peer_views(self, t):
        """The n ranks' twins of ``t`` (a contiguous tensor inside the
        local heap), in rank order; this rank's is ``t``'s memory."""
        if not self.contains(t) or not t.is_contiguous():
            raise ValueError("peer_views takes a contiguous tensor inside "
                             "the local symmetric heap")
        off = t.data_ptr() - self._own
        end = off + t.numel() * t.element_size()
        return [t if r == self.mesh.rank else
                b[off:end].view(t.dtype).view(t.shape)
                for r, b in enumerate(self._bytes)]

    def slot(self, numel, dtype=torch.float32):
        """The next exchange slot (the two alternate call by call), as a
        [numel] ``dtype`` view of the local heap."""
        nbytes = _nbytes((numel,), dtype)
        if nbytes > self.slot_bytes:
            raise ValueError(f"an exchange of {nbytes} bytes exceeds the "
                             f"heap's {self.slot_bytes}-byte slots")
        slot = self._slots[self._parity]
        self._parity ^= 1
        return slot[:nbytes].view(dtype)

    def close(self):
        """Barrier, close the peers' mappings, free the heap."""
        if self._own is None:
            return
        self.mesh.barrier()
        self._bytes = self._local = self._slots = None
        for p in self._opened:
            self._lib.call("dstpu_ipc_close", self._dev, p)
        self._opened = []
        self._lib.call("dstpu_heap_free", self._dev, self._own)
        self._own = None
        if self.mesh.heap is self:
            self.mesh.heap = None
