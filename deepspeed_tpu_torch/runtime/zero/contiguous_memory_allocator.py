"""A defragmenting arena of sub-tensors over one flat CPU tensor.

Port of ``deepspeed_tpu/runtime/zero/contiguous_memory_allocator.py``:
one contiguous buffer serves many tensor-sized sub-allocations (best
fit); when the free space suffices but no single free block does,
``allocate_tensor`` compacts the live tensors to the front (keeping
their contents) and carves again. A move replaces a tensor's view:
callers read live tensors through ``get_tensor(tensor_id)`` after any
allocation. ``align_elems`` > 1 starts every sub-allocation on a
multiple of that many elements from a page-aligned base, so that the
O_DIRECT swap tier's slices submit zero-copy.
"""

import logging

import torch

logger = logging.getLogger("deepspeed_tpu_torch")


class ContiguousMemoryAllocator:
    def __init__(self, size, dtype=torch.float32, align_elems=1):
        self.dtype = dtype
        self.align_elems = max(1, int(align_elems))
        size = -(-int(size) // self.align_elems) * self.align_elems
        itemsize = torch.empty((), dtype=dtype).element_size()
        if self.align_elems > 1:
            from deepspeed_tpu_torch.ops.native.aio import aligned_empty
            self.buffer = aligned_empty(size * itemsize).view(dtype)
            self.buffer.zero_()
        else:
            self.buffer = torch.zeros(size, dtype=dtype)
        self.size = size

        self.free_blocks = {0: self.size}      # offset -> free length
        self.tensor_addresses = {}             # id -> offset
        self.tensor_sizes = {}                 # id -> rounded length
        self.tensor_numels = {}                # id -> requested length
        self.tensor_map = {}                   # id -> live view

        self.total_free = self.size
        self.max_allocated = 0
        self.count = 0

    def allocate_tensor(self, numel):
        """(tensor_id, view) of ``numel`` elements; raises when the arena
        has not that much free in total, defragments when no single free
        block fits."""
        numel = int(numel)
        alloc = -(-numel // self.align_elems) * self.align_elems
        if alloc > self.total_free:
            raise MemoryError(f"arena exhausted: need {alloc}, free "
                              f"{self.total_free}")
        if self._largest_free() < alloc:
            logger.info(f"arena defragment: need {alloc} contiguous, largest "
                        f"free {self._largest_free()} of {self.total_free}")
            self._defragment()
        offset = self._find_block(alloc)
        self._carve(offset, alloc)
        self.count += 1
        tid = self.count
        view = self.buffer[offset:offset + numel]
        self.tensor_addresses[tid] = offset
        self.tensor_sizes[tid] = alloc
        self.tensor_numels[tid] = numel
        self.tensor_map[tid] = view
        self.total_free -= alloc
        self.max_allocated = max(self.max_allocated,
                                 self.size - self.total_free)
        return tid, view

    def get_tensor(self, tensor_id):
        """The live view (read it again after any allocation)."""
        return self.tensor_map[tensor_id]

    def release_tensor(self, tensor_id):
        offset = self.tensor_addresses.pop(tensor_id)
        alloc = self.tensor_sizes.pop(tensor_id)
        self.tensor_numels.pop(tensor_id)
        del self.tensor_map[tensor_id]
        self.total_free += alloc
        self._free(offset, alloc)

    def allocated_ids(self):
        return sorted(self.tensor_addresses)

    def _largest_free(self):
        return max(self.free_blocks.values(), default=0)

    def _find_block(self, numel):
        best = None
        for off, length in self.free_blocks.items():
            if length >= numel and (best is None or length < best[1]):
                best = (off, length)
        return best[0] if best else None

    def _carve(self, offset, numel):
        length = self.free_blocks.pop(offset)
        if length > numel:
            self.free_blocks[offset + numel] = length - numel

    def _free(self, offset, numel):
        # merge with the free neighbours
        end = offset + numel
        nxt = self.free_blocks.pop(end, None)
        if nxt is not None:
            numel += nxt
        for off in list(self.free_blocks):
            if off + self.free_blocks[off] == offset:
                offset = off
                numel += self.free_blocks.pop(off)
                break
        self.free_blocks[offset] = numel

    def _defragment(self):
        """Slide the live tensors to the front in address order, copying
        their contents and replacing their views."""
        cursor = 0
        for tid in sorted(self.tensor_addresses,
                          key=lambda t: self.tensor_addresses[t]):
            offset = self.tensor_addresses[tid]
            numel = self.tensor_numels[tid]
            if offset != cursor:
                # a leftward slide may overlap its source: copy it first
                self.buffer[cursor:cursor + numel] = \
                    self.buffer[offset:offset + numel].clone()
                self.tensor_addresses[tid] = cursor
                self.tensor_map[tid] = self.buffer[cursor:cursor + numel]
            cursor += self.tensor_sizes[tid]
        self.free_blocks = {cursor: self.size - cursor} \
            if cursor < self.size else {}
