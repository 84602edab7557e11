"""Block-sparse attention layout generators, for the port.

The port's own copy of ``deepspeed_tpu/ops/sparse_attention/
sparsity_config.py`` (numpy only): ``SparsityConfig``, ``Dense``,
``Fixed``, ``Variable``, ``BigBird``, ``BSLongformer`` and
``config_to_sparsity``, with the same layouts, the same error messages
and the same draws from numpy's global RNG in the same order, so a
layout made after the same ``np.random.seed`` is equal bit for bit.
Each pattern is the union of a few boolean component masks over the
block grid (same-window, banded, row/column stripes), with causality
applied once as a final ``np.tril``. Layouts are ``[num_heads,
num_blocks, num_blocks]`` 0/1 arrays consumed by
``ops/cuda/blocksparse.py``.
"""

import numpy as np


def _stripe(nb, indices=None, ranges=None):
    """Boolean [nb] vector marking global block positions, from either a
    list of single block indices (negative = from the end, numpy-style) or
    (start, end) ranges. Out-of-range entries are clipped/ignored."""
    cols = np.zeros(nb, dtype=bool)
    if ranges is not None:
        for start, end in ranges:
            cols[start:min(end, nb)] = True
    elif indices is not None:
        valid = [i for i in indices if -nb <= i < nb]
        cols[valid] = True
    return cols


def _same_window(window_ids):
    """[nb] window ids -> [nb, nb] mask of (row, col) in the same window."""
    return window_ids[:, None] == window_ids[None, :]


def _banded(nb, half_width):
    """[nb, nb] mask of |row - col| <= half_width (sliding window)."""
    idx = np.arange(nb)
    return np.abs(idx[:, None] - idx[None, :]) <= half_width


def _random_cols(nb, k):
    """[nb, nb] mask with k distinct random columns per row (vectorized:
    rank a random score matrix per row and keep the k smallest)."""
    mask = np.zeros((nb, nb), dtype=bool)
    if k > 0:
        picks = np.argpartition(np.random.rand(nb, nb), k - 1, axis=1)[:, :k]
        mask[np.arange(nb)[:, None], picks] = True
    return mask


class SparsityConfig:
    """Base: holds head count, block size, per-head layout switch."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def _num_blocks(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block size {self.block}")
        return seq_len // self.block

    def _head_mask(self, h, num_blocks):
        """Boolean [num_blocks, num_blocks] attention-block mask for head h."""
        raise NotImplementedError

    def make_layout(self, seq_len):
        nb = self._num_blocks(seq_len)
        heads = [self._head_mask(h, nb) for h in range(self.num_layout_heads)]
        heads.extend(heads[0] for _ in range(self.num_heads - len(heads)))
        return np.stack(heads).astype(np.int64)


class DenseSparsityConfig(SparsityConfig):
    """All-ones layout: lets the sparse kernel path run dense (reference
    sparsity_config.py:60-ish Dense class)."""

    def _head_mask(self, h, num_blocks):
        return np.ones((num_blocks, num_blocks), dtype=bool)


class FixedSparsityConfig(SparsityConfig):
    """'Fixed' pattern (Sparse Transformers, Child et al. 2019): local windows
    of `num_local_blocks`, plus global attention to a `num_global_blocks`-wide
    column slot inside each window; the slot offset rotates across head
    groups when `num_different_global_patterns` > 1, and rows of the same
    slots become global too under `horizontal_global_attention`."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_local_blocks=4,
                 num_global_blocks=1,
                 attention="bidirectional",
                 horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"Number of blocks in a local window ({num_local_blocks}) must be "
                f"dividable by number of global blocks ({num_global_blocks})")
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only unidirectional or bidirectional attentions are supported")
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "only bidirectional attention can support horizontal global attention")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "number of different global attentions is only valid if "
                "different layouts are generated per head")
        if num_different_global_patterns > (num_local_blocks // num_global_blocks):
            raise ValueError(
                f"Number of layout versions ({num_different_global_patterns}) cannot "
                f"be larger than number of local window blocks divided by number of "
                f"global blocks")
        self.num_different_global_patterns = num_different_global_patterns

    def _global_cols(self, h, num_blocks):
        """Boolean [nb] vector of global block-columns for head h: inside
        every complete window, the G-wide slot ending `pattern_index`
        slots from the window end; in an incomplete tail window, its last
        G columns."""
        L, G = self.num_local_blocks, self.num_global_blocks
        slot_start = L - (1 + h % self.num_different_global_patterns) * G
        idx = np.arange(num_blocks)
        phase = idx % L
        complete = num_blocks - num_blocks % L
        cols = (idx < complete) & (phase >= slot_start) & (phase < slot_start + G)
        if complete < num_blocks:
            cols |= idx >= max(complete, num_blocks - G)
        return cols

    def _head_mask(self, h, num_blocks):
        window_ids = np.arange(num_blocks) // self.num_local_blocks
        mask = _same_window(window_ids)
        gcols = self._global_cols(h, num_blocks)
        mask |= gcols[None, :]
        if self.horizontal_global_attention:
            mask |= gcols[:, None]
        if self.attention == "unidirectional":
            mask = np.tril(mask)
        return mask


class VariableSparsityConfig(SparsityConfig):
    """'Variable' pattern: random blocks + variable-size local windows +
    explicit global block indices/ranges (reference sparsity_config.py:243)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_random_blocks=0,
                 local_window_blocks=(4,),
                 global_block_indices=(0,),
                 global_block_end_indices=None,
                 attention="bidirectional",
                 horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        if global_block_end_indices is not None:
            if len(global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices must have "
                    "the same length")
            for start, end in zip(global_block_indices, global_block_end_indices):
                if start >= end:
                    raise ValueError(
                        f"global block start index ({start}) must be smaller than "
                        f"its end index ({end})")
        self.global_block_end_indices = (list(global_block_end_indices)
                                         if global_block_end_indices is not None else None)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only unidirectional or bidirectional attentions are supported")
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "only bidirectional attention can support horizontal global attention")
        self.horizontal_global_attention = horizontal_global_attention

    def _window_ids(self, num_blocks):
        """Assign each block a window id from the configured window sizes;
        the last size repeats to cover the rest of the sequence."""
        bounds = list(np.cumsum(self.local_window_blocks))
        tail = self.local_window_blocks[-1]
        while bounds[-1] < num_blocks:
            bounds.append(bounds[-1] + tail)
        return np.searchsorted(np.asarray(bounds), np.arange(num_blocks),
                               side="right")

    def _head_mask(self, h, num_blocks):
        if num_blocks < self.num_random_blocks:
            raise ValueError(
                f"Number of random blocks ({self.num_random_blocks}) must be smaller "
                f"than overall number of blocks in a row ({num_blocks})")
        mask = _random_cols(num_blocks, self.num_random_blocks)
        mask |= _same_window(self._window_ids(num_blocks))
        if self.global_block_end_indices is not None:
            gcols = _stripe(num_blocks, ranges=zip(self.global_block_indices,
                                                   self.global_block_end_indices))
        else:
            gcols = _stripe(num_blocks, indices=self.global_block_indices)
        mask |= gcols[None, :]
        if self.horizontal_global_attention:
            mask |= gcols[:, None]
        if self.attention == "unidirectional":
            mask = np.tril(mask)
        return mask


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (Zaheer et al. 2020): random + sliding window + global
    first/last blocks (reference sparsity_config.py:421)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_random_blocks=1,
                 num_sliding_window_blocks=3,
                 num_global_blocks=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks

    def _head_mask(self, h, num_blocks):
        for name, need in (("random", self.num_random_blocks),
                           ("sliding window", self.num_sliding_window_blocks),
                           ("global", self.num_global_blocks)):
            if num_blocks < need:
                raise ValueError(
                    f"Number of {name} blocks ({need}) must be smaller than "
                    f"overall number of blocks in a row ({num_blocks})")
        mask = _random_cols(num_blocks, self.num_random_blocks)
        mask |= _banded(num_blocks, self.num_sliding_window_blocks // 2)
        g = self.num_global_blocks
        edges = _stripe(num_blocks, ranges=[(0, g), (num_blocks - g, num_blocks)])
        mask |= edges[None, :]
        mask |= edges[:, None]
        return mask


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + explicit global block
    indices/ranges (reference sparsity_config.py:544)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_sliding_window_blocks=3,
                 global_block_indices=(0,),
                 global_block_end_indices=None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        if global_block_end_indices is not None:
            if len(global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices must have "
                    "the same length")
            for start, end in zip(global_block_indices, global_block_end_indices):
                if start >= end:
                    raise ValueError(
                        f"global block start index ({start}) must be smaller than "
                        f"its end index ({end})")
        self.global_block_end_indices = (list(global_block_end_indices)
                                         if global_block_end_indices is not None else None)

    def _head_mask(self, h, num_blocks):
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(
                f"Number of sliding window blocks ({self.num_sliding_window_blocks}) "
                f"must be smaller than overall number of blocks in a row ({num_blocks})")
        mask = _banded(num_blocks, self.num_sliding_window_blocks // 2)
        if self.global_block_end_indices is not None:
            g = _stripe(num_blocks, ranges=zip(self.global_block_indices,
                                               self.global_block_end_indices))
        else:
            g = _stripe(num_blocks, indices=self.global_block_indices)
        mask |= g[None, :]
        mask |= g[:, None]
        return mask


def config_to_sparsity(sa_config, num_heads):
    """Build a SparsityConfig from the json section
    (``config/config.py`` ``SparseAttentionConfig``) — the dispatch the
    reference does in config.py:236-406."""
    mode = sa_config.mode
    if mode == "dense":
        return DenseSparsityConfig(num_heads, sa_config.block,
                                   sa_config.different_layout_per_head)
    if mode == "fixed":
        return FixedSparsityConfig(
            num_heads, sa_config.block, sa_config.different_layout_per_head,
            sa_config.num_local_blocks, sa_config.num_global_blocks,
            sa_config.attention, sa_config.horizontal_global_attention,
            sa_config.num_different_global_patterns)
    if mode == "variable":
        return VariableSparsityConfig(
            num_heads, sa_config.block, sa_config.different_layout_per_head,
            sa_config.num_random_blocks, sa_config.local_window_blocks,
            sa_config.global_block_indices, sa_config.global_block_end_indices,
            sa_config.attention, sa_config.horizontal_global_attention)
    if mode == "bigbird":
        return BigBirdSparsityConfig(
            num_heads, sa_config.block, sa_config.different_layout_per_head,
            sa_config.num_random_blocks, sa_config.num_sliding_window_blocks,
            sa_config.num_global_blocks)
    if mode == "bslongformer":
        return BSLongformerSparsityConfig(
            num_heads, sa_config.block, sa_config.different_layout_per_head,
            sa_config.num_sliding_window_blocks, sa_config.global_block_indices,
            sa_config.global_block_end_indices)
    raise NotImplementedError(f"Given sparsity mode, {mode}, has not been implemented yet!")
