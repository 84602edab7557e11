"""The ``serving`` block of the DeepSpeed-style config, for the port.

The port's own copy of ``deepspeed_tpu/config/config.py:ServingConfig``
and the constants it reads: same keys, same defaults, same validation
messages. Sub-blocks whose modules are not ported yet raise
``NotImplementedError`` naming the ROADMAP item instead of being
dropped on the floor.
"""

import json
import os

SERVING = "serving"
SERVING_ENABLED = "enabled"
SERVING_SLOTS = "slots"
SERVING_PAGE_SIZE = "page_size"
SERVING_MAX_PAGES_PER_SLOT = "max_pages_per_slot"
SERVING_NUM_BLOCKS = "num_blocks"
SERVING_KV_CACHE_BITS = "kv_cache_bits"
SERVING_QUANTIZE_BITS = "quantize_bits"

SERVING_DEFAULTS = {
    SERVING_ENABLED: True,          # presence of the block enables it
    SERVING_SLOTS: 8,
    SERVING_PAGE_SIZE: 128,
    SERVING_MAX_PAGES_PER_SLOT: 16,
    SERVING_NUM_BLOCKS: 0,          # 0 → slots * max_pages + 1 (trash)
    SERVING_KV_CACHE_BITS: 0,
    SERVING_QUANTIZE_BITS: 0,
}

# sub-blocks the JAX package serves and the port does not yet
_NOT_PORTED = ("prefix_cache", "speculative", "elastic", "autoscale",
               "disaggregation", "router")
ROADMAP_SERVING = ("ROADMAP.md queue 2, item \"serving modules left out "
                   "of the first slice\"")
ROADMAP_INT8 = ("ROADMAP.md queue 2, item \"int8 KV (kv_quant_int8 + the "
                "int8 paged pool) and int8 weight codes\"")


class DeepSpeedConfigError(ValueError):
    pass


def load_param_dict(config):
    """Resolve a path / JSON string / dict into the raw param dict."""
    if config is None:
        return {}
    if isinstance(config, dict):
        return dict(config)
    if isinstance(config, str):
        if os.path.exists(config):
            with open(config) as f:
                return json.load(f)
        try:
            return json.loads(config)
        except json.JSONDecodeError:
            raise DeepSpeedConfigError(
                f"Expected a string path to an existing deepspeed config, "
                f"or a valid JSON string, but received: {config}")
    raise DeepSpeedConfigError(
        f"Expected a string path, JSON string, or dict; got {type(config)}")


class ServingConfig:
    """``serving`` block: the continuous-batching engine with a paged KV
    cache. Presence of the block enables it; geometry maps 1:1 onto
    PagedCacheSpec."""

    def __init__(self, param_dict):
        d = param_dict.get(SERVING, None)
        self.enabled = d is not None and bool(
            d.get(SERVING_ENABLED, SERVING_DEFAULTS[SERVING_ENABLED]))
        d = d or {}
        for name in _NOT_PORTED:
            sub = d.get(name, None)
            if sub is not None and not (isinstance(sub, dict)
                                        and sub.get("enabled") is False):
                raise NotImplementedError(
                    f"serving.{name} is not ported to deepspeed_tpu_torch "
                    f"yet ({ROADMAP_SERVING})")

        def get(key):
            return int(d.get(key, SERVING_DEFAULTS[key]))

        self.slots = get(SERVING_SLOTS)
        self.page_size = get(SERVING_PAGE_SIZE)
        self.max_pages_per_slot = get(SERVING_MAX_PAGES_PER_SLOT)
        self.num_blocks = get(SERVING_NUM_BLOCKS)
        self.kv_cache_bits = get(SERVING_KV_CACHE_BITS)
        self.quantize_bits = get(SERVING_QUANTIZE_BITS)
        if self.kv_cache_bits not in (0, 8):
            raise DeepSpeedConfigError(
                f"serving.kv_cache_bits must be 0 or 8, got "
                f"{self.kv_cache_bits}")
        if self.quantize_bits not in (0, 8):
            raise DeepSpeedConfigError(
                f"serving.quantize_bits must be 0 or 8, got "
                f"{self.quantize_bits}")
        if self.slots < 1 or self.page_size < 1 \
                or self.max_pages_per_slot < 1:
            raise DeepSpeedConfigError(
                "serving.slots / page_size / max_pages_per_slot must be "
                f"positive, got {self.slots}/{self.page_size}/"
                f"{self.max_pages_per_slot}")
        min_blocks = self.slots * self.max_pages_per_slot + 1
        if self.num_blocks and self.num_blocks < self.slots + 1:
            raise DeepSpeedConfigError(
                f"serving.num_blocks {self.num_blocks} cannot even hold "
                f"one page per slot (+1 reserved trash block); need >= "
                f"{self.slots + 1} (fully-provisioned: {min_blocks})")
        for key, what in ((SERVING_KV_CACHE_BITS, "the int8 paged KV pool"),
                          (SERVING_QUANTIZE_BITS, "int8 weight codes")):
            if getattr(self, key) == 8:
                raise NotImplementedError(
                    f"serving.{key}: 8 ({what}) is not ported to "
                    f"deepspeed_tpu_torch yet ({ROADMAP_INT8})")
