"""The DeepSpeed-style config, for the port.

The port's own copy of what it reads of
``deepspeed_tpu/config/config.py``: ``DeepSpeedConfig`` (the batch
triangle, optimizer, scheduler, fp16/bf16, gradient clipping,
``data_types``, the ZeRO stage) and ``ServingConfig``, with the same keys,
defaults and validation messages, and ``SparseAttentionConfig``.
Blocks and sub-blocks whose modules are
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


# sparse_attention block keys and defaults (deepspeed_tpu/config/
# constants.py:261-292)
SPARSE_ATTENTION = "sparse_attention"
SPARSE_DEFAULTS = {
    "mode": "fixed",
    "block": 16,
    "different_layout_per_head": False,
    "num_local_blocks": 4,
    "num_global_blocks": 1,
    "attention": "bidirectional",
    "horizontal_global_attention": False,
    "num_different_global_patterns": 1,
    "num_random_blocks": 0,
    "local_window_blocks": [4],
    "global_block_indices": [0],
    "global_block_end_indices": None,
    "num_sliding_window_blocks": 3,
}


class SparseAttentionConfig:
    """``sparse_attention`` block: the kwargs of the layout generators
    (``ops/sparse_attention/sparsity_config.config_to_sparsity`` turns it
    into one). As in the JAX package the engine only parses it; a model
    takes the layout through its own config
    (``SparseAttentionUtils.sparse_config_for``)."""

    def __init__(self, param_dict):
        d = param_dict.get(SPARSE_ATTENTION, None)
        self.enabled = d is not None
        d = d or {}

        def get(key, cast=None):
            value = d.get(key, SPARSE_DEFAULTS[key])
            return cast(value) if cast else value

        self.mode = get("mode")
        self.block = get("block", int)
        self.different_layout_per_head = get("different_layout_per_head",
                                             bool)
        self.num_local_blocks = get("num_local_blocks", int)
        self.num_global_blocks = get("num_global_blocks", int)
        self.attention = get("attention")
        self.horizontal_global_attention = get("horizontal_global_attention",
                                               bool)
        self.num_different_global_patterns = get(
            "num_different_global_patterns", int)
        self.num_random_blocks = get("num_random_blocks", int)
        self.local_window_blocks = get("local_window_blocks")
        self.global_block_indices = get("global_block_indices")
        self.global_block_end_indices = get("global_block_end_indices")
        self.num_sliding_window_blocks = get("num_sliding_window_blocks", int)


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
ROADMAP_LONG_CONTEXT = "ROADMAP.md queue 1, item \"Long context\""
ROADMAP_HOOKS = ("ROADMAP.md queue 1, item \"Engine telemetry, watchdog, "
                 "elastic and fault-tolerance hooks\"")
ROADMAP_AUX = ("ROADMAP.md queue 1, item \"Auxiliary parity\"")
ROADMAP_LAMB_SGD = ("ROADMAP.md queue 1, item \"LAMB and SGD\"")
ROADMAP_PIPE = ("ROADMAP.md queue 1, item \"Pipeline\"")
# what JAX's InfinityEngine silently ignores, logged as a fault of the
# reference
ROADMAP_INFINITY = ("ROADMAP.md section 3, \"JAX's InfinityEngine ignores "
                    "gradient_clipping, fp16, gradient accumulation and the "
                    "scheduler\"")


def _present(d):
    """A block given as a dict without ``enabled: false``."""
    return isinstance(d, dict) and d.get("enabled", True) is not False


def _enabled(d):
    """A block given with ``enabled: true``."""
    return isinstance(d, dict) and bool(d.get("enabled", False))


# block → (is it on in this param dict?, ROADMAP item): everything the
# JAX engine reads that the port's engine does not run yet
_TRAINING_NOT_PORTED = {
    "zero_optimization.stage3_prefetch_gather 'fused' (XLA's own "
    "collective schedule)":
        (lambda pd: _zero(pd).get("stage3_prefetch_gather") == "fused",
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
    "activation_checkpointing": (lambda pd: any(
        (pd.get("activation_checkpointing") or {}).get(k, False)
        for k in ("partition_activations", "cpu_checkpointing")),
        ROADMAP_MULTI_RANK),
    "pipeline": (lambda pd: int((pd.get("pipeline") or {})
                                .get("stages", 1)) > 1, ROADMAP_PIPE),
    "mesh": (lambda pd: any(int((pd.get("mesh") or {}).get(k, 1)) > 1
                            for k in ("model", "pipe", "seq", "expert")),
             ROADMAP_MULTI_RANK),
}

# optimizer types the JAX engine builds and the port does not yet
_OPTIMIZERS_NOT_PORTED = {"lamb": ROADMAP_LAMB_SGD,
                          "fusedlamb": ROADMAP_LAMB_SGD,
                          "sgd": ROADMAP_LAMB_SGD,
                          "onebitadam": ROADMAP_STREAM,
                          "onebitlamb": ROADMAP_STREAM}


def _zero(pd):
    z = pd.get("zero_optimization", {})
    if isinstance(z, bool):   # legacy "zero_optimization": true == stage 1
        return {"stage": 1 if z else 0}
    return z or {}


# zero_optimization's stage-3 knobs (deepspeed_tpu/config/constants.py:
# 199-238) and its collective_matmul sub-block
ZERO_STAGE3_PREFETCH_GATHER_MODES = ("ring", "fused", "fused_matmul")
CM_BACKEND_MODES = ("auto", "fused", "lax")
ZERO_DEFAULTS = {"stage3_prefetch": False, "stage3_prefetch_gather": "ring",
                 "stage3_param_persistence_threshold": 1e5,
                 "stage3_max_live_parameters": 1e9,
                 "stage3_prefetch_bucket_size": 5e7}
CM_DEFAULTS = {"backend": "auto", "tile_m": 128, "min_shard_bytes": 1 << 16,
               "vmem_budget_bytes": 8 << 20}


OFFLOAD_DEVICES = ("none", "cpu", "nvme")


class ZeroOffloadConfig:
    """``offload_param`` / ``offload_optimizer``, with JAX's keys,
    defaults and messages (``deepspeed_tpu/config/config.py:29-87``):
    ``device`` (none, cpu, nvme), ``nvme_path``, ``buffer_count``, the
    swappers' ``pipeline_read`` / ``pipeline_write`` / ``fsync``, and
    ``stream`` (offload_optimizer only: "auto" and "device" update on the
    card with the state in pinned host memory, "host" runs the native
    SIMD step), ``stream_segments`` (offload_param only)."""

    def __init__(self, d, role="optimizer"):
        d = d or {}
        self.device = d.get("device", "none") or "none"
        if self.device not in OFFLOAD_DEVICES:
            raise DeepSpeedConfigError(
                f"offload device must be one of {OFFLOAD_DEVICES}, got "
                f"{self.device!r}")
        self.nvme_path = d.get("nvme_path", None)
        self.buffer_count = int(d.get("buffer_count", 5))
        self.pipeline_read = bool(d.get("pipeline_read", False))
        self.pipeline_write = bool(d.get("pipeline_write", False))
        self.fsync = bool(d.get("fsync", False))
        if self.buffer_count < 1:
            raise DeepSpeedConfigError(
                f"offload buffer_count must be >= 1, got {self.buffer_count}")
        self.stream = str(d.get("stream", "auto"))
        self.stream_segments = int(d.get("stream_segments", 0))
        if role != "optimizer":
            if "stream" in d:
                raise DeepSpeedConfigError(
                    "'stream' applies to offload_optimizer only (the param "
                    "tier is pinned_host/NVMe residency, not a step mode)")
        elif self.stream_segments:
            raise DeepSpeedConfigError(
                "'stream_segments' applies to offload_param only")
        elif self.stream not in ("auto", "device", "host"):
            raise DeepSpeedConfigError(
                f"offload stream must be auto|device|host, got "
                f"{self.stream!r}")

    @property
    def enabled(self):
        return self.device != "none"


class AioConfig:
    """``aio`` block (``deepspeed_tpu/config/config.py:668``): the async
    I/O handles' knobs and ``o_direct``."""

    def __init__(self, param_dict):
        import mmap
        d = param_dict.get("aio", {}) or {}
        self.block_size = int(d.get("block_size", 1048576))
        self.queue_depth = int(d.get("queue_depth", 8))
        self.thread_count = int(d.get("thread_count", 1))
        self.single_submit = bool(d.get("single_submit", False))
        self.overlap_events = bool(d.get("overlap_events", True))
        o_direct = d.get("o_direct", False)
        if not isinstance(o_direct, bool):
            raise DeepSpeedConfigError(
                f"aio.o_direct must be a bool, got {o_direct!r}")
        self.o_direct = o_direct
        if self.block_size <= 0:
            raise DeepSpeedConfigError(
                f"aio.block_size must be positive, got {self.block_size}")
        if self.o_direct and self.block_size % mmap.PAGESIZE:
            raise DeepSpeedConfigError(
                f"aio.o_direct requires aio.block_size to be a multiple of "
                f"the page size ({mmap.PAGESIZE}); got {self.block_size} — "
                f"O_DIRECT transfer lengths must stay aligned")


class ZeroConfig:
    """``zero_optimization``'s stage, bucket and stage-3 knobs, with JAX's
    validation messages (``deepspeed_tpu/config/config.py:106-211``).
    ``overlap_reduce`` is validated with JAX's message and
    ``allgather_bucket_size`` is accepted, both for parity and both
    ignored: the n-rank bucket stream runs the ring form whatever they
    say (JAX's keys tune XLA's collectives on TPU interconnects).
    ``collective_matmul``'s ``tile_m`` and ``vmem_budget_bytes`` shape
    the TPU kernel's grid and VMEM; the CUDA kernels' tiles are fixed, so
    the port validates and keeps them."""

    def __init__(self, param_dict):
        z = _zero(param_dict)
        D = ZERO_DEFAULTS
        self.stage = int(z.get("stage", 0))
        self.stage3_prefetch = bool(z.get("stage3_prefetch",
                                          D["stage3_prefetch"]))
        self.stage3_prefetch_gather = str(z.get(
            "stage3_prefetch_gather", D["stage3_prefetch_gather"]))
        if self.stage3_prefetch_gather not in \
                ZERO_STAGE3_PREFETCH_GATHER_MODES:
            raise DeepSpeedConfigError(
                f"zero_optimization.stage3_prefetch_gather must be one of "
                f"{ZERO_STAGE3_PREFETCH_GATHER_MODES}, got "
                f"{self.stage3_prefetch_gather!r}")
        cm = z.get("collective_matmul", {}) or {}
        if not isinstance(cm, dict):
            raise DeepSpeedConfigError(
                f"zero_optimization.collective_matmul must be a dict of "
                f"{{backend, tile_m, min_shard_bytes, vmem_budget_bytes}}, "
                f"got {cm!r}")
        self.collective_matmul_backend = str(cm.get("backend",
                                                    CM_DEFAULTS["backend"]))
        if self.collective_matmul_backend not in CM_BACKEND_MODES:
            raise DeepSpeedConfigError(
                f"zero_optimization.collective_matmul.backend must be one of "
                f"{CM_BACKEND_MODES}, got "
                f"{self.collective_matmul_backend!r}")
        self.collective_matmul_tile_m = int(cm.get("tile_m",
                                                   CM_DEFAULTS["tile_m"]))
        self.collective_matmul_min_shard_bytes = int(cm.get(
            "min_shard_bytes", CM_DEFAULTS["min_shard_bytes"]))
        if self.collective_matmul_tile_m <= 0:
            raise DeepSpeedConfigError(
                f"zero_optimization.collective_matmul.tile_m must be "
                f"positive, got {self.collective_matmul_tile_m}")
        if self.collective_matmul_min_shard_bytes < 0:
            raise DeepSpeedConfigError(
                f"zero_optimization.collective_matmul.min_shard_bytes must "
                f"be >= 0, got {self.collective_matmul_min_shard_bytes}")
        self.collective_matmul_vmem_budget_bytes = int(cm.get(
            "vmem_budget_bytes", CM_DEFAULTS["vmem_budget_bytes"]))
        if self.collective_matmul_vmem_budget_bytes <= 0:
            raise DeepSpeedConfigError(
                f"zero_optimization.collective_matmul.vmem_budget_bytes "
                f"must be positive, got "
                f"{self.collective_matmul_vmem_budget_bytes}")
        if self.stage3_prefetch and self.stage != 3:
            raise DeepSpeedConfigError(
                f"zero_optimization.stage3_prefetch requires stage 3, got "
                f"stage {self.stage}")
        self.param_persistence_threshold = int(z.get(
            "stage3_param_persistence_threshold",
            D["stage3_param_persistence_threshold"]))
        self.max_live_parameters = int(z.get(
            "stage3_max_live_parameters", D["stage3_max_live_parameters"]))
        self.prefetch_bucket_size = int(z.get(
            "stage3_prefetch_bucket_size", D["stage3_prefetch_bucket_size"]))
        # the offload tiers (config.py:136-148): the legacy flat flags
        # switch the blocks on
        self.offload_param = ZeroOffloadConfig(z.get("offload_param"),
                                               role="param")
        self.offload_optimizer = ZeroOffloadConfig(z.get("offload_optimizer"))
        if z.get("cpu_offload", False) and not self.offload_optimizer.enabled:
            self.offload_optimizer.device = "cpu"
        if z.get("cpu_offload_params", False) \
                and not self.offload_param.enabled:
            self.offload_param.device = "cpu"
        self.overlap_comm = bool(z.get("overlap_comm", False))
        self.reduce_bucket_size = int(z.get("reduce_bucket_size", 5e8))
        overlap_reduce = str(z.get("overlap_reduce", "ring"))
        if overlap_reduce not in ("ring", "fused"):
            raise DeepSpeedConfigError(
                f"zero_optimization.overlap_reduce must be 'ring' or "
                f"'fused', got {overlap_reduce!r}")
        if self.overlap_comm and not self.offload_optimizer.enabled \
                and self.reduce_bucket_size <= 0:
            raise DeepSpeedConfigError(
                f"zero_optimization.reduce_bucket_size must be positive "
                f"when overlap_comm is on, got {self.reduce_bucket_size}")
        for role, c in (("offload_optimizer", self.offload_optimizer),
                        ("offload_param", self.offload_param)):
            if c.device == "nvme" and not c.nvme_path:
                raise DeepSpeedConfigError(
                    f"{role} device=nvme requires nvme_path")
        if self.offload_optimizer.stream == "device" and \
                self.offload_optimizer.device == "nvme":
            raise DeepSpeedConfigError(
                "offload_optimizer stream='device' supports device='cpu' "
                "with Adam/AdamW only (NVMe state and LAMB run on the host "
                "runner)")


# MoQ quantize-aware training and progressive layer drop: the keys and
# defaults of deepspeed_tpu/config/constants.py:508-567
QUANTIZE_TRAINING = "quantize_training"
QUANTIZE_DEFAULTS = {
    "enabled": False,
    "start_bits": 16, "target_bits": 8,
    "quantize_period": 1000, "schedule_offset": 1000,
    "quantize_groups": 1,
    "fp16_mixed_quantize": False, "quantize_change_ratio": 0.001,
    "quantize_verbose": False, "quantizer_kernel": True,
}
EIGENVALUE_DEFAULTS = {
    "enabled": False, "verbose": False, "max_iter": 100, "tol": 1e-2,
    "stability": 1e-6, "gas_boundary_resolution": 1,
    "layer_name": "bert.encoder.layer", "layer_num": 0,
}
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_DEFAULTS = {"enabled": False, "theta": 0.5, "gamma": 0.001}


class QuantizeTrainingConfig:
    """``quantize_training`` block (``config/config.py:604``): MoQ's
    progressive bit reduction and its optional eigenvalue modulation."""

    def __init__(self, param_dict):
        d = param_dict.get(QUANTIZE_TRAINING, {})
        D = QUANTIZE_DEFAULTS
        self.enabled = bool(d.get("enabled", D["enabled"]))
        bits = d.get("quantize_bits", {})
        self.start_bits = int(bits.get("start_bits", D["start_bits"]))
        self.target_bits = int(bits.get("target_bits", D["target_bits"]))
        sched = d.get("quantize_schedule", {})
        self.quantize_period = int(sched.get("quantize_period",
                                             D["quantize_period"]))
        self.schedule_offset = int(sched.get("schedule_offset",
                                             D["schedule_offset"]))
        self.groups = int(d.get("quantize_groups", D["quantize_groups"]))
        algo = d.get("quantize_algo", {})
        self.q_type = 1 if algo.get("q_type") == "asymmetric" else 0
        self.q_rounding = 1 if algo.get("rounding") == "stochastic" else 0
        mixed = d.get("fp16_mixed_quantize", {})
        self.fp16_mixed_quantize = bool(mixed.get(
            "enabled", D["fp16_mixed_quantize"]))
        self.quantize_change_ratio = float(mixed.get(
            "quantize_change_ratio", D["quantize_change_ratio"]))
        self.verbose = bool(d.get("quantize_verbose",
                                  D["quantize_verbose"]))
        # read for compatibility: JAX, and the port, always run the kernel
        self.quantizer_kernel = bool(d.get("quantizer_kernel",
                                           D["quantizer_kernel"]))
        ev = d.get("eigenvalue", {})
        E = EIGENVALUE_DEFAULTS
        self.eigenvalue_enabled = bool(ev.get("enabled", E["enabled"]))
        self.eigenvalue_verbose = bool(ev.get("verbose", E["verbose"]))
        self.eigenvalue_max_iter = int(ev.get("max_iter", E["max_iter"]))
        self.eigenvalue_tol = float(ev.get("tol", E["tol"]))
        self.eigenvalue_stability = float(ev.get("stability",
                                                 E["stability"]))
        self.eigenvalue_gas_boundary_resolution = int(ev.get(
            "gas_boundary_resolution", E["gas_boundary_resolution"]))
        self.eigenvalue_layer_name = str(ev.get("layer_name",
                                                E["layer_name"]))
        self.eigenvalue_layer_num = int(ev.get("layer_num", E["layer_num"]))


class PLDConfig:
    """``progressive_layer_drop`` block (``config/config.py:660``)."""

    def __init__(self, param_dict):
        d = param_dict.get(PROGRESSIVE_LAYER_DROP, {})
        self.enabled = bool(d.get("enabled", PLD_DEFAULTS["enabled"]))
        self.theta = float(d.get("theta", PLD_DEFAULTS["theta"]))
        self.gamma = float(d.get("gamma", PLD_DEFAULTS["gamma"]))


class DeepSpeedConfig:
    """The training config — the port's copy of
    ``deepspeed_tpu/config/config.py:1307`` for what the port's training
    paths read. ``world_size`` is the data-parallel world size of the
    batch triangle; ``mesh.data``, when given, must equal it."""

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
        self.zero_config = ZeroConfig(pd)
        self.aio_config = AioConfig(pd)
        # the optimizer tiers run at world size n on each rank's slices
        # (stages 0-2) or shards (stage 3, off the prefetch pipeline); the
        # parameter tier is ZeRO-Infinity's
        zc = self.zero_config
        if self.world_size > 1 and zc.offload_param.enabled:
            raise NotImplementedError(
                f"the parameter tier (offload_param) at world size "
                f"{self.world_size} is not ported ({ROADMAP_MULTI_RANK})")
        data = int((pd.get("mesh") or {}).get("data", 1))
        if data > 1 and data != self.world_size:
            raise DeepSpeedConfigError(
                f"mesh.data {data} must equal the world size "
                f"{self.world_size}")

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
        self.sparse_attention_config = SparseAttentionConfig(pd)
        self.pld_config = PLDConfig(pd)
        self.quantize_training_config = QuantizeTrainingConfig(pd)
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
