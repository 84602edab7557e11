"""Paged KV cache: a pooled block store plus host-side page accounting.

Port of ``deepspeed_tpu/serving/paged_cache.py:47,69,537,548``
(exclusive ownership; prefix sharing waits):

- device side: a pair of ``[Lyr, num_blocks, H, page_size, D]`` K/V
  tensors on the engine's device, updated IN PLACE by prefill and tick —
  the port's counterpart of the JAX engine's donated pool. With
  ``kv_cache_bits=8`` the pool is ``(k codes, k scale, v codes, v
  scale)``: int8 ``[Lyr, NB, H, page, D]`` codes and fp32 ``[Lyr, NB, H,
  1, page]`` per-row scales (the JAX pool, paged_cache.py:84-96);
- host side: a LIFO free list of block ids and per-slot page tables
  ``[slots, max_pages_per_slot]`` int32. A request's pages are allocated
  on admission (prompt + max_new_tokens) and freed when it finishes.

Block 0 is RESERVED as the trash block: idle slots' page-table entries
and the pad tail of shorter tables point at it, so every append has a
legal target and idle slots never corrupt a live block.
"""

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

TRASH_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PagedCacheSpec:
    """Geometry of a paged pool (the ``serving`` config block makes one)."""
    n_layers: int
    kv_heads: int
    head_dim: int
    page_size: int = 128
    num_blocks: int = 0          # 0 → slots * max_pages_per_slot + 1
    max_pages_per_slot: int = 16
    slots: int = 8
    kv_cache_bits: int = 0       # 0 = dtype storage, 8 = int8 codes
    dtype: Any = torch.bfloat16

    def resolved_num_blocks(self) -> int:
        if self.num_blocks > 0:
            return self.num_blocks
        return self.slots * self.max_pages_per_slot + 1  # +1: trash

    def max_tokens_per_slot(self) -> int:
        return self.max_pages_per_slot * self.page_size


class PagedKVCache:
    """Device block pool + host page allocator for one model's caches.
    ``pool`` is the ``(k, v)`` pair of device tensors, or ``(k codes, k
    scale, v codes, v scale)`` for an int8 pool."""

    def __init__(self, spec: PagedCacheSpec, device):
        if spec.kv_cache_bits not in (0, 8):
            raise ValueError(f"kv_cache_bits must be 0 or 8, got "
                             f"{spec.kv_cache_bits}")
        self.spec = spec
        nb = spec.resolved_num_blocks()
        assert nb >= 2, "need at least one allocatable block past trash"
        shape = (spec.n_layers, nb, spec.kv_heads, spec.page_size,
                 spec.head_dim)
        if spec.kv_cache_bits == 8:
            sshape = shape[:3] + (1, spec.page_size)
            self.pool = tuple(
                torch.zeros(s, dtype=dt, device=device)
                for s, dt in ((shape, torch.int8), (sshape, torch.float32),
                              (shape, torch.int8), (sshape, torch.float32)))
        else:
            self.pool = (torch.zeros(shape, dtype=spec.dtype, device=device),
                         torch.zeros(shape, dtype=spec.dtype, device=device))
        self.num_blocks = nb
        # LIFO free list: recently-freed blocks are re-used first, which
        # is what the slot-reuse tests lean on to catch stale reads
        self._free: List[int] = list(range(nb - 1, TRASH_BLOCK, -1))
        self.page_table = np.full((spec.slots, spec.max_pages_per_slot),
                                  TRASH_BLOCK, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(spec.slots)]

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.spec.page_size)

    def admit(self, slot: int, total_tokens: int) -> Optional[List[int]]:
        """Allocate pages covering ``total_tokens`` rows into ``slot``'s
        page table. Returns the page list, or None (nothing allocated)
        when the pool can't cover it."""
        n = self.pages_needed(total_tokens)
        assert n <= self.spec.max_pages_per_slot, (
            f"request needs {n} pages > max_pages_per_slot "
            f"{self.spec.max_pages_per_slot} (page_size "
            f"{self.spec.page_size})")
        assert not self._slot_pages[slot], f"slot {slot} already admitted"
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._slot_pages[slot] = pages
        row = self.page_table[slot]
        row[:] = TRASH_BLOCK
        row[:n] = pages
        return pages

    def release(self, slot: int) -> None:
        """Return ``slot``'s pages to the free list (on EOS/finish)."""
        self._free.extend(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.page_table[slot, :] = TRASH_BLOCK


def pow2_page_bucket(need: int, max_pages: int) -> int:
    """Next-pow2 bucket of a page count, clamped to the position budget:
    prefill runs O(log max_pages) shapes, not one per prompt length."""
    b = 1
    while b < need:
        b *= 2
    return min(b, max_pages)


def padded_prefill_inputs(prompt: np.ndarray, pages: List[int],
                          page_size: int, max_pages: int):
    """Pow2-bucketed prefill inputs: token ids zero-padded to the page
    bucket, page vector TRASH-padded to the same bucket."""
    S = len(prompt)
    n_pages = pow2_page_bucket(max(1, -(-S // page_size)), max_pages)
    ids = np.zeros((1, n_pages * page_size), np.int32)
    ids[0, :S] = prompt
    page_vec = np.full((n_pages,), TRASH_BLOCK, np.int32)
    k = min(n_pages, len(pages))
    page_vec[:k] = pages[:k]
    return ids, page_vec
