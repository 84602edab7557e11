"""MoQ: quantize-aware training with progressive bit reduction.

Port of ``deepspeed_tpu/runtime/quantize.py`` ``Quantizer``: every
``q_period`` optimizer steps the precision of the eligible weights falls
by one bit toward ``q_target_bits``, the period doubling after each
reduction; optionally blended with the unquantized weights
(``fp16_mixed_quantize``) and with per-layer periods scaled by Hessian
eigenvalues (``runtime/eigenvalue.py``). The schedule is JAX's statement
for statement.

``quantize_tree`` takes the model's named tensors (the engine's fp32
masters) and quantizes the eligible ones in place with the grouped
kernel (``ops/cuda/quantize.py`` ``quantize_leaves``: one launch a
boundary over a table of every eligible leaf, the blend inside it).
Eligible, as in JAX, is a floating leaf that is 2-D in the JAX tree of
the model's layout (``jax_paths``): under the unrolled layout the
embeddings and the four kernels of each layer; under the scan layout,
where a layer kernel is one 3-D leaf stacked over the layers, the
embeddings and the layer-stacked [L, ·] biases and LayerNorm parameters,
each one leaf of the table whose pieces are its L layer tensors, its
groups running over their concatenation.
"""

import logging

import torch

from deepspeed_tpu_torch.ops.cuda.quantize import quantize_leaves

logger = logging.getLogger("deepspeed_tpu_torch")

# number of 2-D parameters per transformer layer (reference quantize.py:9)
TWO_D_PARAMS = 6


def jax_leaves(named, jax_paths):
    """Group the model's named tensors into the leaves of its JAX tree:
    [(JAX path, names, stacked)], the names of a stacked leaf in layer
    order. ``jax_paths``: {name: (path, layer or None)}, the bridge's
    ``jax_paths``; None makes every tensor a leaf of its own, named by its
    dotted name."""
    if jax_paths is None:
        return [(tuple(name.split(".")), [name], False) for name in named]
    leaves = {}
    for name in named:
        path, layer = jax_paths[name]
        leaves.setdefault(path, {})[layer] = name
    out = []
    for path, by_layer in leaves.items():
        if None in by_layer:
            out.append((path, [by_layer[None]], False))
        else:
            out.append((path, [by_layer[i] for i in sorted(by_layer)], True))
    return out


def eligible_leaves(named, jax_paths):
    """The leaves MoQ quantizes, as ``jax_leaves`` gives them: floating
    and 2-D in the JAX tree."""
    out = []
    for path, names, stacked in jax_leaves(named, jax_paths):
        t = named[names[0]]
        if t.is_floating_point() and t.dim() + int(stacked) == 2:
            out.append((path, names, stacked))
    return out


class Quantizer:
    def __init__(self,
                 q_target_bits=8,
                 q_start_bits=16,
                 q_period=100,
                 q_offset=100,
                 q_groups=1,
                 q_mixed_fp16=False,
                 q_change_ratio=0.01,
                 q_type=0,                 # 0 symmetric / 1 asymmetric
                 q_rounding=0,             # 0 nearest / 1 stochastic
                 q_verbose=False,
                 q_eigenvalue=False,
                 layer_num=0):
        self.q_target_bits = q_target_bits
        self.layer_num = layer_num
        n = layer_num if layer_num != 0 else 1
        self.q_start_bits = [q_start_bits] * n
        self.q_period = [q_period] * n
        self.q_offset = q_offset
        self.q_groups = q_groups
        self.q_mixed_fp16 = q_mixed_fp16
        self.q_change_ratio = q_change_ratio
        self.q_type = q_type
        self.q_rounding = q_rounding
        self.q_verbose = q_verbose
        self.q_eigenvalue = q_eigenvalue
        self.qsteps = 0
        self.quantize_real_ratio = 1.0
        self._leaves = None

    # -- schedule ---------------------------------------------------------

    def any_precision_switch(self):
        """Will the next update change any layer's precision?"""
        return any(b != self.q_target_bits for b in self.q_start_bits)

    def _maybe_reduce_bits(self, index):
        """Advance layer ``index``'s schedule; True if its bits changed."""
        if self.q_start_bits[index] <= self.q_target_bits:
            return False
        if self.qsteps >= self.q_period[index]:
            self.q_start_bits[index] -= 1
            self.q_period[index] = int(self.q_period[index] * 2)
            if self.q_verbose:
                logger.info(
                    f"MoQ: layer {index} → {self.q_start_bits[index]} bits "
                    f"at step {self.qsteps}, next period "
                    f"{self.q_period[index]}")
            return True
        return False

    def update_fp16_ratio(self):
        """Decay the blend with the unquantized weights toward 0."""
        if self.q_mixed_fp16 and self.quantize_real_ratio > 0:
            self.quantize_real_ratio = max(
                0.0, self.quantize_real_ratio - self.q_change_ratio)

    def eigenvalue_adjust(self, eigenvalues):
        """Scale per-layer periods by normalized eigenvalues: flatter
        layers quantize sooner."""
        if not eigenvalues:
            return
        ev = [max(float(e), 1e-12) for e in eigenvalues]
        mean = sum(ev) / len(ev)
        for i in range(min(self.layer_num or 1, len(ev))):
            factor = ev[i] / mean
            self.q_period[i] = max(1, int(self.q_period[i] * factor))

    # -- application ------------------------------------------------------

    def _layer_index(self, path_names):
        """A JAX path's layer for per-layer schedules (``h_3`` → 3)."""
        if self.layer_num == 0:
            return 0
        for name in path_names:
            for tok in name.replace("_", ".").split("."):
                if tok.isdigit():
                    return min(int(tok), self.layer_num - 1)
        return 0

    def _eligible(self, named, jax_paths):
        """``eligible_leaves`` as [(names, layer index)], kept from the
        last boundary while the names and the ``jax_paths`` object are the
        same (an engine passes the same ones every boundary)."""
        key = (tuple(named), id(jax_paths))
        if self._leaves is None or self._leaves[0] != key:
            self._leaves = (key, jax_paths, [
                (names, self._layer_index([str(k) for k in path]))
                for path, names, _ in eligible_leaves(named, jax_paths)])
        return self._leaves[2]

    def advance(self, overflow=False, eigenvalues=None):
        """The schedule's step at one boundary; False when the boundary
        quantizes nothing (an overflow step without the mixed blend)."""
        if overflow and not self.q_mixed_fp16:
            # overflow steps consume no schedule budget
            return False
        self.qsteps += TWO_D_PARAMS * (self.layer_num if self.layer_num
                                       else 1)
        if self.q_eigenvalue and eigenvalues:
            self.eigenvalue_adjust(eigenvalues)
        for i in range(len(self.q_start_bits)):
            self._maybe_reduce_bits(i)
        self.update_fp16_ratio()
        return True

    def quantize_tree(self, named, jax_paths=None, overflow=False,
                      eigenvalues=None, generator=None):
        """One MoQ boundary (JAX's ``quantize_tree``): advance the
        schedule, then fake-quantize every eligible leaf in place at its
        layer's bits. ``named``: {name: fp tensor}; ``jax_paths``: the
        model's {name: (JAX path, layer or None)} (None: each tensor a
        leaf). Returns the names of the tensors it quantized."""
        if not self.advance(overflow, eigenvalues):
            return []
        table, changed = [], []
        for names, layer in self._eligible(named, jax_paths):
            bits = self.q_start_bits[layer]
            if bits >= 16:
                continue
            pieces = [named[n] for n in names]
            groups = self.q_groups \
                if sum(p.numel() for p in pieces) % self.q_groups == 0 else 1
            table.append((pieces, bits, groups))
            changed += names
        blend = self.q_mixed_fp16 and self.quantize_real_ratio > 0
        with torch.no_grad():
            quantize_leaves(table, sym=self.q_type == 0,
                            stochastic=self.q_rounding == 1,
                            ratio=self.quantize_real_ratio if blend else None,
                            generator=generator)
        return changed
