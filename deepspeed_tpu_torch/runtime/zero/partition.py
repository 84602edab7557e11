"""ZeRO's shard choice, for the port.

Port of ``deepspeed_tpu/runtime/zero/partition.py``: ``shard_spec_for_leaf``
(:41) and ``ZeroPartitioner`` (:69): stage 3 cuts parameters at rest,
stage 2 and up cuts gradients, stage 1 and up the optimizer's moments,
each with the same data-axis rule. A leaf is cut on
the data axis along its largest free dimension that the axis size
divides; on a tie the lower dimension wins (Python's sort is stable with
``reverse=True``, as JAX's is). A leaf below ``min_size`` elements, or
below the axis size, stays replicated (the reference's
``stage3_param_persistence_threshold``). ``exclude_dims`` keeps the
layer dimension of layer-stacked leaves whole, so the prefetch pipeline
slices whole layers locally.

The shard dimension decides which kernel variants the fused gather runs.
GPT-2's scan layout stacks c_attn's kernel as [L, E, 3E] and c_fc's as
[L, E, 4E]: they cut their output dimension. attn c_proj [L, E, E] ties
and mlp c_proj [L, 4E, E] leads on the input dimension: they cut the
contracting one.

A spec is a tuple over the leaf's dimensions of an axis name or None
(JAX's ``PartitionSpec``).
"""

import math

from deepspeed_tpu_torch.parallel.mesh import DATA_AXIS


def shard_spec_for_leaf(shape, dp_size, base_spec=None, min_size=0,
                        axis_name=DATA_AXIS, exclude_dims=()):
    """Extend ``base_spec`` with a data-axis shard on the largest free,
    divisible dimension; ``base_spec`` unchanged when no dimension
    qualifies or the leaf is below ``min_size`` elements."""
    shape = tuple(int(s) for s in shape)
    base = tuple(base_spec) if base_spec is not None else ()
    base = base + (None,) * (len(shape) - len(base))
    if dp_size <= 1 or math.prod(shape or (1,)) < max(min_size, dp_size):
        return base
    candidates = sorted(
        (d for d in range(len(shape))
         if d not in exclude_dims and base[d] is None
         and shape[d] % dp_size == 0 and shape[d] >= dp_size),
        key=lambda d: shape[d], reverse=True)
    if not candidates:
        return base
    new = list(base)
    new[candidates[0]] = axis_name
    return tuple(new)


def plan_from_specs(shapes, specs, axis_name, n):
    """Per-leaf ``(dim, shard_size)`` where ``dim`` carries ``axis_name``,
    or None for a leaf the spec leaves replicated
    (``parallel/prefetch.py:56``)."""
    plan = []
    for shape, spec in zip(shapes, specs):
        entry = None
        for d, ax in enumerate(spec):
            axes = ax if isinstance(ax, tuple) else (ax,)
            if axis_name in axes:
                entry = (d, int(shape[d]) // n)
                break
        plan.append(entry)
    return plan


class ZeroPartitioner:
    """Data-axis specs for a dict of leaf shapes ({name: shape}) at a ZeRO
    stage. Names are '/'-joined paths; a name whose first part is in
    ``layer_stacked_prefixes`` is a layer-stacked leaf ([L, ...]) whose
    layer dimension is never cut. The JAX engine passes the persistence
    threshold at stage 3 alone (``engine.py:213``); its callers do too."""

    def __init__(self, dp, stage, param_persistence_threshold=0):
        if not 0 <= stage <= 3:
            raise ValueError(f"invalid ZeRO stage {stage}")
        self.dp = int(dp)
        self.stage = int(stage)
        self.min_size = int(param_persistence_threshold)
        self.layer_stacked_prefixes = ()

    def _zero_spec(self, name, shape):
        exclude = (0,) if name.split("/")[0] in \
            self.layer_stacked_prefixes else ()
        return shard_spec_for_leaf(shape, self.dp, min_size=self.min_size,
                                   exclude_dims=exclude)

    def _specs(self, shapes, from_stage):
        if self.stage < from_stage:
            return {k: (None,) * len(s) for k, s in shapes.items()}
        return {k: self._zero_spec(k, s) for k, s in shapes.items()}

    def param_specs(self, shapes):
        """Stage 3 shards parameters at rest; stages 0-2 keep them whole."""
        return self._specs(shapes, 3)

    def grad_specs(self, shapes):
        """Stage >= 2: gradients sharded (a reduce-scatter); else whole."""
        return self._specs(shapes, 2)

    def opt_param_like_specs(self, shapes):
        """Stage >= 1: the moments sharded as stage-3 parameters are."""
        return self._specs(shapes, 1)

    def explicit_shard_plan(self, shapes, specs=None):
        """[(dim, shard_size) or None] aligned with ``shapes``' order: the
        slice of each leaf whose update a rank owns (its moment shard),
        None for a leaf every rank updates whole (``:180``). ``specs``
        overrides the moment specs (the stage-3 prefetch path passes its
        parameter specs, so the plan is the resting layout)."""
        specs = self.opt_param_like_specs(shapes) if specs is None else specs
        return plan_from_specs(list(shapes.values()),
                               [specs[k] for k in shapes], DATA_AXIS,
                               self.dp)
