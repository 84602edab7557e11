"""The DeepSpeed-style config, for the port.

The port's own copy of what it reads of
``deepspeed_tpu/config/config.py``: ``DeepSpeedConfig`` (the batch
triangle, optimizer, scheduler, fp16/bf16, gradient clipping,
``data_types``, the ZeRO stage) and ``ServingConfig``, with the same keys,
defaults and validation messages. Blocks and sub-blocks whose modules are
not ported yet raise ``NotImplementedError`` naming the ROADMAP item
instead of being dropped on the floor.
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


# -- training ----------------------------------------------------------------

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_CHIP = "train_micro_batch_size_per_chip"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
STEPS_PER_PRINT_DEFAULT = 10
SEED_DEFAULT = 1234

ROADMAP_OFFLOAD = ("ROADMAP.md queue 1, item \"ZeRO-Offload / Infinity on "
                   "one H100\"")
ROADMAP_MULTI_RANK = ("ROADMAP.md queue 1, item \"ZeRO stages over "
                      "torch.distributed\"")
ROADMAP_STREAM = ("ROADMAP.md queue 1, item \"Multi-GPU ZeRO-3 stream\"")
ROADMAP_HOOKS = ("ROADMAP.md queue 1, item \"Engine telemetry, watchdog, "
                 "elastic and fault-tolerance hooks\"")
ROADMAP_AUX = ("ROADMAP.md queue 1, item \"Auxiliary parity\"")
ROADMAP_LAMB_SGD = ("ROADMAP.md queue 1, item \"LAMB and SGD\"")
ROADMAP_PIPE = ("ROADMAP.md queue 1, item \"Pipeline\"")
ROADMAP_LONG = ("ROADMAP.md queue 1, item \"Long context\"")


def _present(d):
    """A block given as a dict without ``enabled: false``."""
    return isinstance(d, dict) and d.get("enabled", True) is not False


def _enabled(d):
    """A block given with ``enabled: true``."""
    return isinstance(d, dict) and bool(d.get("enabled", False))


# block → (is it on in this param dict?, ROADMAP item): everything the
# JAX engine reads that the port's engine does not run yet
_TRAINING_NOT_PORTED = {
    "zero_optimization.offload_optimizer / offload_param / cpu_offload":
        (lambda pd: _zero_offload(pd), ROADMAP_OFFLOAD),
    "zero_optimization.stage3_prefetch":
        (lambda pd: bool(_zero(pd).get("stage3_prefetch", False)),
         ROADMAP_STREAM),
    "comm.hierarchy":
        (lambda pd: _present((pd.get("comm") or {}).get("hierarchy")),
         ROADMAP_STREAM),
    "sparse_gradients": (lambda pd: bool(pd.get("sparse_gradients", False)),
                         ROADMAP_AUX),
    "elasticity": (lambda pd: _enabled(pd.get("elasticity")), ROADMAP_HOOKS),
    "snapshot": (lambda pd: _present(pd.get("snapshot")), ROADMAP_HOOKS),
    "monitor": (lambda pd: _present(pd.get("monitor")), ROADMAP_HOOKS),
    "tensorboard": (lambda pd: _enabled(pd.get("tensorboard")),
                    ROADMAP_HOOKS),
    "fault_tolerance": (lambda pd: _present(pd.get("fault_tolerance")),
                        ROADMAP_HOOKS),
    "profiling": (lambda pd: bool((pd.get("profiling") or {})
                                  .get("trace_dir")), ROADMAP_HOOKS),
    "wall_clock_breakdown": (lambda pd: bool(pd.get("wall_clock_breakdown",
                                                    False)), ROADMAP_HOOKS),
    "flops_profiler": (lambda pd: _enabled(pd.get("flops_profiler")),
                       ROADMAP_AUX),
    "progressive_layer_drop": (lambda pd: _enabled(
        pd.get("progressive_layer_drop")), ROADMAP_AUX),
    "quantize_training (MoQ)": (lambda pd: _enabled(
        pd.get("quantize_training")), ROADMAP_AUX),
    "activation_checkpointing": (lambda pd: any(
        (pd.get("activation_checkpointing") or {}).get(k, False)
        for k in ("partition_activations", "cpu_checkpointing")),
        ROADMAP_MULTI_RANK),
    "pipeline": (lambda pd: int((pd.get("pipeline") or {})
                                .get("stages", 1)) > 1, ROADMAP_PIPE),
    "sparse_attention": (lambda pd: pd.get("sparse_attention") is not None,
                         ROADMAP_LONG),
    "mesh": (lambda pd: any(int((pd.get("mesh") or {}).get(k, 1)) > 1
                            for k in ("data", "model", "pipe", "seq",
                                      "expert")), ROADMAP_MULTI_RANK),
}

# optimizer types the JAX engine builds and the port does not yet
_OPTIMIZERS_NOT_PORTED = {"lamb": ROADMAP_LAMB_SGD,
                          "fusedlamb": ROADMAP_LAMB_SGD,
                          "sgd": ROADMAP_LAMB_SGD,
                          "onebitadam": ROADMAP_STREAM,
                          "onebitlamb": ROADMAP_STREAM,
                          "cpuadam": ROADMAP_OFFLOAD}


def _zero(pd):
    z = pd.get("zero_optimization", {})
    if isinstance(z, bool):   # legacy "zero_optimization": true == stage 1
        return {"stage": 1 if z else 0}
    return z or {}


def _zero_offload(pd):
    z = _zero(pd)
    return bool(z.get("cpu_offload", False)) \
        or bool(z.get("cpu_offload_params", False)) \
        or any((z.get(k) or {}).get("device", "none") not in (None, "none")
               for k in ("offload_optimizer", "offload_param"))


class DeepSpeedConfig:
    """The training config — the port's copy of
    ``deepspeed_tpu/config/config.py:1307`` for what the single-device
    training path reads. ``world_size`` is the data-parallel world size
    of the batch triangle (1: the port's engine runs one rank)."""

    def __init__(self, config, world_size=1):
        pd = load_param_dict(config)
        self._param_dict = pd
        self.world_size = int(world_size)
        for block, (on, item) in _TRAINING_NOT_PORTED.items():
            if on(pd):
                raise NotImplementedError(
                    f"{block} is not ported to deepspeed_tpu_torch yet "
                    f"({item})")

        self.train_batch_size = pd.get(TRAIN_BATCH_SIZE, None)
        self.train_micro_batch_size_per_gpu = pd.get(
            TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            pd.get(TRAIN_MICRO_BATCH_SIZE_PER_CHIP, None))
        self.gradient_accumulation_steps = pd.get(GRADIENT_ACCUMULATION_STEPS,
                                                  None)
        self.steps_per_print = pd.get("steps_per_print",
                                      STEPS_PER_PRINT_DEFAULT)
        self.seed = int(pd.get("seed", SEED_DEFAULT))

        self.zero_optimization_stage = int(_zero(pd).get("stage", 0))
        if not 0 <= self.zero_optimization_stage <= 3:
            raise DeepSpeedConfigError(
                f"invalid ZeRO stage {self.zero_optimization_stage}")
        self.zero_enabled = self.zero_optimization_stage > 0

        self.gradient_clipping = pd.get("gradient_clipping", 0.0)

        fp16 = pd.get("fp16", {})
        self.fp16_enabled = bool(fp16.get("enabled", False))
        self.loss_scale = fp16.get("loss_scale", 0)
        self.initial_scale_power = fp16.get("initial_scale_power", 32)
        self.loss_scale_window = fp16.get("loss_scale_window", 1000)
        self.hysteresis = fp16.get("hysteresis", 2)
        self.min_loss_scale = fp16.get("min_loss_scale", 1)

        bf16 = pd.get("bf16", pd.get("bfloat16", {}))
        self.bf16_enabled = bool(bf16.get("enabled", False))
        precision = pd.get("precision", None)
        if precision is not None:
            self.bf16_enabled = precision in ("bfloat16", "bf16")
            self.fp16_enabled = precision in ("float16", "fp16")

        data_types = pd.get("data_types", {})
        self.grad_accum_dtype = data_types.get(
            "grad_accum_dtype", bf16.get("grad_accum_dtype", "fp32"))
        if self.grad_accum_dtype not in ("fp32", "bf16"):
            raise DeepSpeedConfigError(
                f"grad_accum_dtype must be 'fp32' or 'bf16', got "
                f"{self.grad_accum_dtype!r}")
        self.grad_dtype = data_types.get("grad_dtype", "fp32")
        if self.grad_dtype not in ("fp32", "bf16"):
            raise DeepSpeedConfigError(
                f"grad_dtype must be 'fp32' or 'bf16', got "
                f"{self.grad_dtype!r}")

        self.optimizer_name = None
        self.optimizer_params = None
        opt = pd.get("optimizer", None)
        if opt:
            self.optimizer_name = opt.get("type", None)
            if self.optimizer_name:
                self.optimizer_name = self.optimizer_name.lower()
            self.optimizer_params = opt.get("params", {})
            if self.optimizer_name in _OPTIMIZERS_NOT_PORTED:
                raise NotImplementedError(
                    f"optimizer {self.optimizer_name!r} is not ported to "
                    f"deepspeed_tpu_torch yet "
                    f"({_OPTIMIZERS_NOT_PORTED[self.optimizer_name]})")

        self.scheduler_name = None
        self.scheduler_params = None
        sched = pd.get("scheduler", None)
        if sched:
            self.scheduler_name = sched.get("type", None)
            self.scheduler_params = sched.get("params", {})

        self.serving_config = ServingConfig(pd)
        self._set_batch_related_parameters()
        if self.fp16_enabled and self.bf16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        for ok, msg in (
                (train_batch > 0, f"Train batch size: {train_batch} has to "
                                  f"be greater than 0"),
                (micro_batch > 0, f"Micro batch size per gpu: {micro_batch} "
                                  f"has to be greater than 0"),
                (grad_acc > 0, f"Gradient accumulation steps: {grad_acc} "
                               f"has to be greater than 0"),
                (train_batch == micro_batch * grad_acc * self.world_size,
                 f"Check batch related parameters. train_batch_size is not "
                 f"equal to micro_batch_per_gpu * gradient_acc_step * "
                 f"world_size {train_batch} != {micro_batch} * {grad_acc} "
                 f"* {self.world_size}")):
            if not ok:
                raise AssertionError(msg)

    def _set_batch_related_parameters(self):
        """Solve the batch triangle, as config.py:1518 does."""
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if all(x is not None for x in (train_batch, micro_batch, grad_acc)):
            pass
        elif train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = \
                train_batch // micro_batch // self.world_size
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided")
        self._batch_assertion()
