"""DeepSpeedEngine for one device: the fused train path of the JAX engine.

Port of ``deepspeed_tpu/runtime/engine.py:131`` as its 1-device fused path
builds it (``_build_jit_fns`` :1474): per micro batch the loss and its
gradients (``_micro_loss_and_grads`` :2718), gradient accumulation in
``grad_accum_dtype`` divided by gas (:1480-1523), then one update
(``_apply_grads`` :1394): the fp32 global norm, the loss-scale inverse and
the clip coefficient folded into one ``grad_scale``, skip on fp16
overflow, and ``global_step`` counted only on finite steps. Also
``train_batch`` (:2808), ``forward``/``backward``/``step`` (:3229-3281),
``eval_batch`` and checkpoints. Progressive layer drop feeds the model
its keep probability, and MoQ (``runtime/quantize.py``) fake-quantizes
the fp32 masters in place at each step boundary (``_moq_boundary``
:3321), its eigenvalues (``runtime/eigenvalue.py``) on the CPU only.

Where JAX casts fp32 parameters to bf16 inside the differentiated
function (``data_types.grad_dtype: "bf16"``), the port keeps the model's
parameters as the bf16 compute copy and the fp32 masters beside them (the
reference DeepSpeed's fp16 engine shape): gradients come out bf16, and the
copy is refreshed from the masters after each step (after MoQ, when it
runs). With fp32 gradients the model's parameters are the masters.

Counters that JAX keeps on the device (the step count the LR schedule
reads, the loss scale) stay device tensors, so a step reads nothing back
to the host; the loss is read back only every ``steps_per_print`` steps,
where the JAX engine reads it too. ZeRO stages 0-3 run at world size 1
with nothing partitioned, as the JAX engine does on a 1-device mesh.

At world size n > 1 (a ``parallel.mesh.Mesh`` of n ranks) ZeRO stages 0-2
run the JAX engine's explicit form of them, ``_build_overlap_train_fn``
(:1840) in its ring form, whatever ``overlap_comm`` and
``overlap_reduce`` say: JAX runs ``overlap_comm: false`` on its fused
GSPMD exchange and ``overlap_reduce: "fused"`` on ``lax.psum``, which
compute the same function (they tune XLA's collectives on TPU
interconnects), and the port has this one form of it. Each rank holds the fp32 masters and the
compute copy whole (replicated), and the AdamW moments of its slice of
every leaf (``ZeroPartitioner.explicit_shard_plan``; a leaf the moment
specs leave whole steps whole on every rank). A step takes the rank's
rows of the global batch, accumulates its local gradients over the micro
batches, exchanges them as a stream of buckets (``parallel/overlap.py``
``bucket_stream``: on the card one ``mm_rs_reduce`` launch a bucket over
the peers' heap regions), takes the loss mean, the fp16 finite check,
the global norm and the clip coefficient, steps the rank's slices,
all-gathers the updated slices back into the masters and refreshes the
compute copy. ``forward``/``backward``/``step``, ``eval_batch`` and the
per-rank checkpoints run there too.

ZeRO-Offload at world size n (stages 0-2, ``offload_optimizer``; the
reference's CPU Adam on each rank's partition, ``zero/stage2.py:747-925``):
each rank's offload tier (``_make_offload_runner``) holds the fp32
masters and the moments of the rank's slices (whole at stage 0) in pinned
host memory or on NVMe, and the card keeps the compute copy whole. The
bucket stream, the norms, the finite flags and the clip coefficient run
as above; the tier steps the rank's fp32 mean-gradient slices and writes
the rank's slices of the compute copy, and the compute copy's slices are
all-gathered (half the bytes of the fp32 masters under bf16). Gradients
accumulate on the card over the micro batches before the one stream; the
per-micro copy of gradients to the host under ``overlap_comm``
(``_offload_overlapped_grads``) runs at world size 1 alone. Checkpoints
keep the per-rank windows, the masters cut as the moments are, so a save
restores into either optimizer at any world size.

ZeRO stage 3 at world size n takes one of JAX's two paths
(``_choose_zero3_path``, JAX's ``_compute_prefetch`` :1976). With
``stage3_prefetch``, no offload tier, the model's layered-apply contract
and no user ``loss_fn``, ``train_batch`` runs the JAX engine's
``_build_prefetch_train_fn`` (:2033). Each rank keeps its shard of every
leaf the stage-3 specs cut (``runtime/zero/partition.py``) as fp32
masters with its AdamW moments; the compute copy of the shards lives in
the symmetric heap on the card (``parallel/symmetric_memory.py``). A step
takes the rank's rows of the global batch, gathers the outer leaves once
(custom backward: reduce-scatter), runs the blocks through the prefetch
pipeline (``parallel/prefetch.py``; under ``fused_matmul`` the four
projections stream through the fused kernels), scales the shard
gradients (sums over the ranks) by 1/n, all-reduces the replicated
leaves' gradients and the loss to their means (and under fp16 the finite
flag, so every rank skips together), and updates the shards.

Every other case at stage 3 takes the gather path, JAX's fused GSPMD
stage-3 program (``_build_jit_fns`` :1474) in explicit form: each rank
keeps its shards of the stage-3 plan (``stage3_param_plan``: JAX's
``param_specs`` over the JAX tree's leaves) as fp32 masters and moments
(or in its offload tier) and as compute-copy shards; a step all-gathers
the compute copy whole into the module's parameters before its first
micro batch, runs the module's own forward and backward on the rank's
rows (any model, any ``loss_fn``), releases the whole copy after the
last backward, and runs the bucket stream and update of stages 0-2 on
the rank's shards, which writes the rank's compute-copy shards and
gathers nothing. ``forward``/``backward``/``step`` and ``eval_batch`` run
the gather path's step on either path, on the same shards, as JAX runs
its GSPMD functions there.
"""

import inspect
import logging
import math
import os
import time

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import (ROADMAP_MULTI_RANK,
                                               ROADMAP_OFFLOAD,
                                               DeepSpeedConfig)
from deepspeed_tpu_torch.models.gpt2 import lm_loss
from deepspeed_tpu_torch.ops import fused_collective as fc
from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam, FusedAdam
from deepspeed_tpu_torch.ops.cuda import ROADMAP_SECOND_ORDER
from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer
from deepspeed_tpu_torch.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.parallel import overlap
from deepspeed_tpu_torch.parallel import prefetch as prefetch_lib
from deepspeed_tpu_torch.parallel.symmetric_memory import SymmetricHeap
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.runtime import precision as prec
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue
from deepspeed_tpu_torch.runtime.lr_schedules import (_Schedule,
                                                      get_lr_schedule)
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop
from deepspeed_tpu_torch.runtime.quantize import Quantizer
from deepspeed_tpu_torch.runtime.zero.partition import (ZeroPartitioner,
                                                      stage3_param_plan)
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry
from deepspeed_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("deepspeed_tpu_torch")


def _build_optimizer(name, params_dict):
    p = dict(params_dict or {})
    name = (name or "adam").lower()
    if name not in ("adam", "adamw", "fusedadam", "cpuadam"):
        raise ValueError(f"Unknown optimizer type {name}")
    adam_w = True if name == "adamw" else p.pop("adam_w_mode", True)
    cls = DeepSpeedCPUAdam if name == "cpuadam" else FusedAdam
    opt = cls(lr=p.pop("lr", 1e-3),
                    betas=tuple(p.pop("betas", (0.9, 0.999))),
                    eps=p.pop("eps", 1e-8),
                    weight_decay=p.pop("weight_decay", 0.0),
                    adam_w_mode=adam_w,
                    bias_correction=p.pop("bias_correction", True),
                    moment_dtype=p.pop("moment_dtype", "fp32"))
    if p:
        logger.warning(f"optimizer '{name}' ignores config params: "
                       f"{sorted(p)}")
    return opt


def _world_size():
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class DeepSpeedEngine:
    """See the module docstring."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None, lr_scheduler=None,
                 collate_fn=None, config=None, loss_fn=None, device=None,
                 seed=None, mesh=None):
        if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
            raise NotImplementedError(
                f"mesh must be a deepspeed_tpu_torch.parallel.mesh.Mesh (a "
                f"torch.distributed world), got {type(mesh).__name__}; "
                f"without one the port trains on one rank "
                f"({ROADMAP_MULTI_RANK})")
        if mesh is None and _world_size() > 1:
            mesh = mesh_lib.make_mesh(device=device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        world = 1 if self.mesh is None else self.mesh.size
        self.device = resolve_device(device) if self.mesh is None \
            else self.mesh.device
        self.module = model
        self.collate_fn = collate_fn
        self._loss_fn_user = loss_fn
        self._config = DeepSpeedConfig(config, world_size=world)
        self.metrics = MetricsRegistry()
        if self.mesh is not None:
            self._check_world_path()
        self.zero3_path = self._choose_zero3_path()
        self.precision = prec.PrecisionConfig.from_ds_config(self._config)

        if optimizer is None:
            self.optimizer = _build_optimizer(self._config.optimizer_name,
                                              self._config.optimizer_params)
        elif isinstance(optimizer, TorchOptimizer):
            self.optimizer = optimizer
        else:
            raise TypeError("optimizer must be a deepspeed_tpu_torch "
                            "TorchOptimizer (ops/adam.py FusedAdam)")
        if self.mesh is not None and not getattr(
                self.optimizer, "elementwise_update", False):
            # JAX falls back to its GSPMD exchange here, whose optimizer
            # sees whole leaves; every n-rank path of the port steps slices
            raise NotImplementedError(
                f"{type(self.optimizer).__name__} is not elementwise: the "
                f"per-rank ZeRO update slices leaves, which breaks its "
                f"per-tensor statistics; not ported at world size "
                f"{self.mesh.size} ({ROADMAP_MULTI_RANK})")
        if lr_scheduler is not None:
            self.lr_scheduler = lr_scheduler
        elif self._config.scheduler_name:
            self.lr_scheduler = get_lr_schedule(self._config.scheduler_name,
                                                self._config.scheduler_params,
                                                self.optimizer)
        else:
            self.lr_scheduler = None

        self.progressive_layer_drop = None
        pld = self._config.pld_config
        if pld.enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=pld.theta, gamma=pld.gamma)
        self.quantizer = None
        self.eigenvalue = None
        qcfg = self._config.quantize_training_config
        if qcfg.enabled:
            self.quantizer = Quantizer(
                q_target_bits=qcfg.target_bits,
                q_start_bits=qcfg.start_bits,
                q_period=qcfg.quantize_period,
                q_offset=qcfg.schedule_offset,
                q_groups=qcfg.groups,
                q_mixed_fp16=qcfg.fp16_mixed_quantize,
                q_change_ratio=qcfg.quantize_change_ratio,
                q_type=qcfg.q_type,
                q_rounding=qcfg.q_rounding,
                q_verbose=qcfg.verbose,
                q_eigenvalue=qcfg.eigenvalue_enabled,
                layer_num=qcfg.eigenvalue_layer_num)
            # the model's JAX paths, made once: the boundary's leaves
            self._moq_jax_paths = self.module.jax_paths() \
                if hasattr(self.module, "jax_paths") else None
            if qcfg.eigenvalue_enabled:
                if self.device.type == "cuda":
                    raise NotImplementedError(
                        "quantize_training.eigenvalue needs a Hessian-vector "
                        "product, a second derivative through the CUDA "
                        "attention kernels, which they do not have; it runs "
                        f"on the CPU ({ROADMAP_SECOND_ORDER})")
                self.eigenvalue = Eigenvalue(
                    verbose=qcfg.eigenvalue_verbose,
                    max_iter=qcfg.eigenvalue_max_iter,
                    tol=qcfg.eigenvalue_tol,
                    stability=qcfg.eigenvalue_stability,
                    gas_boundary_resolution=(
                        qcfg.eigenvalue_gas_boundary_resolution),
                    layer_name=qcfg.eigenvalue_layer_name,
                    layer_num=max(qcfg.eigenvalue_layer_num, 1))

        # ZeRO-Offload (engine.py:412): the fp32 masters and the moments on
        # the host or NVMe, the compute copy on the card; the parameters
        # themselves in pinned host memory or on NVMe between steps with
        # offload_param cpu or nvme (engine.py:188-219)
        zc = self._config.zero_config
        self._offload_cfg = zc.offload_optimizer
        self._host_runner = None
        self._param_swapper = None
        self._param_host = None
        self._params_parked = False
        self._parked_via_push = False
        self.offload_marks = None
        if (self._offload_cfg.enabled or zc.offload_param.enabled) \
                and qcfg.enabled:
            raise NotImplementedError(
                f"quantize_training with the offload tiers is not ported: "
                f"MoQ quantizes the masters on the card ({ROADMAP_OFFLOAD})")

        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)

        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.global_samples = 0
        self._seed = self._config.seed if seed is None else int(seed)
        self._pending_grads = None
        self._pending_micro = None
        self._accum_loss = None
        self._last_lr = None
        self._last_grad_norm = None
        self._loss_fn = None
        self._moq_batch = None
        self.world_marks = None
        self._gathered = False
        if self.mesh is None:
            self._init_state(model_parameters)
        elif self._prefetch_active():
            self._init_zero3_state(model_parameters)
        else:
            self._init_world_state(model_parameters)
        # MoQ's stochastic rounding and the eigenvalues' start vectors
        self.generator = torch.Generator(device=self.device).manual_seed(
            self._seed)

    # -- config accessors ----------------------------------------------------
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def steps_per_print(self):
        return self._config.steps_per_print

    def get_lr(self):
        if self._last_lr is not None:
            return [float(self._last_lr)]
        return [float(getattr(self.optimizer, "lr", 0.0))]

    def get_global_grad_norm(self):
        return self._last_grad_norm

    @property
    def loss_scale(self):
        return float(self.scaler["loss_scale"])

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() == 0

    # -- state ---------------------------------------------------------------
    def _place_model(self, model_parameters=None):
        """Place the model on the device: its own weights, the given
        ``model_parameters`` (a state dict), or — for a model made on the
        meta device — fresh ones from ``reset_parameters`` and a seeded
        generator, as the JAX engine calls ``model.init``. Then the names,
        the fp32 parameters (the masters to be), the scaler and the
        counters."""
        model, dev = self.module, self.device
        on_meta = any(p.is_meta for p in model.parameters())
        if on_meta:
            model.to_empty(device=dev)
        else:
            model.to(dev)
        if model_parameters is not None:
            with torch.no_grad():
                model.load_state_dict(
                    {k: v if torch.is_tensor(v) else torch.as_tensor(
                        np.asarray(v)) for k, v in model_parameters.items()})
        elif on_meta:
            model.reset_parameters(
                torch.Generator(device=dev).manual_seed(self._seed))
        self.param_names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        self._module_params = params
        for n, p in zip(self.param_names, params):
            if p.dtype != torch.float32:
                raise ValueError(f"parameter {n} is {p.dtype}: the engine "
                                 f"keeps fp32 master parameters")
        self._bf16_grads = self._config.grad_dtype == "bf16"
        self.scaler = prec.init_scaler_state(self.precision, dev)
        self.global_step_t = torch.zeros((), dtype=torch.int32, device=dev)
        self.skipped_steps_t = torch.zeros((), dtype=torch.int32, device=dev)
        return params

    def _init_state(self, model_parameters=None):
        """The placed model's fp32 masters, its compute copy (the model's
        own parameters, bf16 with grad_dtype bf16) and the optimizer
        state."""
        params = self._place_model(model_parameters)
        if self._offload_cfg.enabled:
            self._init_offload_state(params)
        else:
            self._keep_masters(params)
            self.opt_state = self.optimizer.init(self.master)
        # the first park fills the parameter tier, after the first step
        tier = self._config.zero_config.offload_param.device
        if tier == "nvme":
            self._param_swapper = self._make_param_swapper()
        elif tier == "cpu":
            from deepspeed_tpu_torch.runtime.zero.pinned import \
                HostParamRest
            self._param_host = HostParamRest(self.device)

    def _keep_masters(self, params):
        """The placed parameters' fp32 data become the masters; the
        parameters themselves the compute copy (bf16 with grad_dtype
        bf16, else the masters)."""
        self.master = [p.data for p in params]
        if self._bf16_grads:
            for p in params:
                p.data = p.data.to(torch.bfloat16)
        self.compute_params = params

    def _refresh_compute_params(self):
        if self._prefetch_active():
            return self._refresh_zero3()
        if self._host_runner is not None:
            return      # the offload step writes the compute copy itself
        if self.zero3_path == "gather":
            with torch.no_grad():
                torch._foreach_copy_(self._rest, self.master)
            return
        if self._bf16_grads:
            with torch.no_grad():
                torch._foreach_copy_([p.data for p in self.compute_params],
                                     self.master)

    # -- the loss ------------------------------------------------------------
    def _resolve_loss_fn(self):
        """``_resolve_loss_fn`` (engine.py:1297): the loss is
        ``fn(model, batch, keep_prob)``. A user ``loss_fn`` takes (model,
        batch, rng, keep_prob)[:n] (rng is None in the port); otherwise a
        dict batch with ``input_ids`` (+ ``labels``) is a next-token LM
        loss (fused into the model when it takes ``labels`` and
        ``loss_chunk > 0``), a 2-tuple (x, y) is a cross entropy (integer
        y) or a mean squared error, and a bare array is an LM loss on
        itself. A model whose forward takes ``keep_prob`` gets it."""
        if self._loss_fn_user is not None:
            fn = self._loss_fn_user
            n = len(inspect.signature(fn).parameters)
            return lambda model, batch, keep_prob=1.0: fn(
                *(model, batch, None, keep_prob)[:n])
        try:
            sig = inspect.signature(self.module.forward)
            fused = "labels" in sig.parameters and getattr(
                getattr(self.module, "config", None), "loss_chunk", 0) > 0
            takes_keep = "keep_prob" in sig.parameters
        except (TypeError, ValueError):
            fused = takes_keep = False

        def default_loss(model, batch, keep_prob=1.0):
            kw = {"keep_prob": keep_prob} if takes_keep else {}

            def lm(ids, labels):
                if fused:
                    return model(ids, labels=labels, **kw)
                return lm_loss(model(ids, **kw), labels)

            if isinstance(batch, dict) and "input_ids" in batch:
                return lm(batch["input_ids"],
                          batch.get("labels", batch["input_ids"]))
            if isinstance(batch, (tuple, list)) and len(batch) == 2:
                x, y = batch
                out = model(x, **kw)
                if not torch.is_floating_point(y):
                    logp = torch.log_softmax(out.float(), dim=-1)
                    return -logp.gather(-1, y.long()[..., None]).mean()
                return torch.mean(torch.square(out.float() - y.float()))
            return lm(batch, batch)
        return default_loss

    def _to_device(self, batch):
        return _map(lambda x: torch.as_tensor(np.asarray(x)).to(self.device)
                    if not torch.is_tensor(x) else x.to(self.device), batch)

    def _micro_loss_and_grads(self, micro_batch, loss_fn=None, params=None):
        """(loss, grads) of one micro batch: grads of loss × loss scale,
        in the compute parameters' dtype (bf16 with grad_dtype bf16).
        ``loss_fn(micro, keep_prob)``: the loss (default: the engine's
        loss of the module); ``params``: what the gradients are of
        (default the compute copy)."""
        if self._loss_fn is None:
            self._loss_fn = self._resolve_loss_fn()
        pld = self.progressive_layer_drop
        keep = 1.0 if pld is None else pld.theta_at(self.global_step_t)
        loss = loss_fn(micro_batch, keep) if loss_fn is not None else \
            self._loss_fn(self.module, micro_batch, keep)
        params = self.compute_params if params is None else params
        grads = torch.autograd.grad(
            (loss.float() * self.scaler["loss_scale"]), params,
            allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        return loss.detach().float(), grads

    def _split(self, batch, gas):
        def lead(x):
            return x.shape[0]
        sizes = {lead(x) for x in _leaves(batch)}
        for n in sizes:
            if n % gas:
                raise AssertionError(
                    f"train_batch got leading dim {n} not divisible by "
                    f"gradient_accumulation_steps={gas}; pass a global batch "
                    f"of micro*gas samples or use forward/backward/step")
        return [_map(lambda x, i=i: x[i * (lead(x) // gas):
                                      (i + 1) * (lead(x) // gas)], batch)
                for i in range(gas)]

    def _accumulate_grads(self, batch, loss_fn=None):
        """(grads, loss) over gas micro batches of ``batch``: each micro
        batch's grads in ``grad_accum_dtype``, divided by gas and summed;
        ``loss_fn`` as ``_micro_loss_and_grads`` takes it."""
        gas = self.gradient_accumulation_steps()
        if gas == 1:
            loss, grads = self._micro_loss_and_grads(batch, loss_fn)
            return grads, loss
        acc_dtype = torch.bfloat16 if self._config.grad_accum_dtype == "bf16" \
            else torch.float32
        acc, acc_loss = None, torch.zeros((), device=self.device)
        for micro in self._split(batch, gas):
            loss, grads = self._micro_loss_and_grads(micro, loss_fn)
            part = torch._foreach_div([g.to(acc_dtype) for g in grads], gas)
            if acc is None:
                acc = part
            else:
                torch._foreach_add_(acc, part)
            acc_loss = acc_loss + loss / gas
        return list(acc), acc_loss

    # -- the update ----------------------------------------------------------
    def _lr(self):
        sched = self.lr_scheduler
        if isinstance(sched, _Schedule):
            return sched.lr_at(self.global_step_t).to(torch.float32)
        if callable(sched):
            return torch.as_tensor(sched(self.global_step_t),
                                   dtype=torch.float32, device=self.device)
        return torch.tensor(float(getattr(self.optimizer, "lr", 1e-3)),
                            dtype=torch.float32, device=self.device)

    def _clip_coefficient(self, grads, sq_norm=None):
        """(global gradient norm, unscaled; the one coefficient that
        unscales and clips). ``sq_norm``: the global squared norm of the
        scaled gradients, when the caller has it (one rank's shards, or
        host gradients summed on the host)."""
        inv = 1.0 / self.scaler["loss_scale"]
        if sq_norm is None:
            norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
            sq_norm = torch.stack(norms).square().sum() if norms \
                else torch.zeros((), device=self.device)
        grad_norm = torch.as_tensor(sq_norm, dtype=torch.float32,
                                    device=self.device).sqrt() * inv
        coef = inv
        clip = self._config.gradient_clipping
        if clip and clip > 0:
            coef = inv * torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
        return grad_norm, coef

    def _end_update(self, loss, grad_norm, lr, finite):
        """The loss scaler's update and the step counters after an update
        (``finite`` False: a skipped fp16 step); returns the metrics."""
        if finite is None:
            finite = torch.ones((), dtype=torch.bool, device=self.device)
        self.scaler = prec.update_scaler(self.scaler, self.precision, finite)
        self.global_step_t = self.global_step_t + finite.int()
        self.skipped_steps_t = self.skipped_steps_t + (~finite).int()
        return {"loss": loss, "grad_norm": grad_norm, "lr": lr,
                "overflow": ~finite, "loss_scale": self.scaler["loss_scale"]}

    def _apply_grads(self, grads, loss, sq_norm=None, finite=None):
        """Unscale, clip, step, scaler update in one pass of the update
        (engine.py:1394); the caller refreshes the compute copy. On an
        fp16 overflow the masters and the optimizer state keep their
        values (``_tree_where``): the optimizer folds the finite flag into
        its update. ``sq_norm`` and ``finite``: the global squared
        gradient norm and finite flag, when ``grads`` are one rank's
        shards."""
        with torch.no_grad():
            if finite is None and self.precision.fp16:
                finite = prec.grads_finite(grads)
            grad_norm, gscale = self._clip_coefficient(grads, sq_norm)
            lr = self._lr()
            self.optimizer.step(self.master, grads, self.opt_state, lr,
                                grad_scale=gscale, finite=finite)
            return self._end_update(loss, grad_norm, lr, finite)

    def _after_step(self, metrics):
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self._last_lr = metrics["lr"]
        self._last_grad_norm = metrics["grad_norm"]
        if hasattr(self.lr_scheduler, "step"):
            self.lr_scheduler.step()
        if self.global_steps % self.steps_per_print() == 0:
            self.skipped_steps = int(self.skipped_steps_t)
            logger.info(f"step={self.global_steps}, skipped="
                        f"{self.skipped_steps}, loss="
                        f"{float(metrics['loss']):.6f}, lr={self.get_lr()}, "
                        f"loss_scale={self.loss_scale}")

    # -- public training API -------------------------------------------------
    def train_batch(self, batch=None, data_iter=None):
        """One optimizer step over gas x micro samples; returns the loss
        (a device tensor, not read back). ``batch`` carries the whole
        global batch, or ``data_iter`` yields gas micro batches."""
        if batch is None:
            if data_iter is None:
                raise ValueError("need batch or data_iter")
            micro = [next(data_iter)
                     for _ in range(self.gradient_accumulation_steps())]
            batch = _map_many(lambda *xs: np.concatenate(
                [np.asarray(x) for x in xs]), micro)
        batch = self._to_device(batch)
        self._ensure_params_resident()
        if self.mesh is not None and not self._prefetch_active():
            marks = self._gather_compute_copy()
            grads, loss = self._accumulate_grads(self._rank_rows(batch))
            self._release_compute_copy()
            metrics = self._world_apply_grads(grads, loss)
            if marks is not None and self.world_marks is not None:
                self.world_marks = list(marks) + self.world_marks
            del grads
        elif self._host_runner is not None:
            metrics = self._offload_train_batch(batch)
        else:
            finite = sq_norm = None
            if self._prefetch_active():
                grads, loss, sq_norm, finite = self._zero3_grads(batch)
            else:
                grads, loss = self._accumulate_grads(batch)
            metrics = self._apply_grads(grads, loss, sq_norm, finite)
            del grads
        self.micro_steps += self.gradient_accumulation_steps()
        self._after_step(metrics)
        self._moq_boundary(batch, metrics)
        self._refresh_compute_params()
        self._park_params()
        return metrics["loss"]

    def forward(self, batch):
        """Loss and gradients of one micro batch, kept for
        ``backward``/``step`` (engine.py:3229). At world size n the rank
        takes its rows of the micro batch and keeps its local gradients;
        the loss returned is the mean over the ranks, the micro batch's
        loss as JAX returns it. At ZeRO stage 3 (either path: JAX runs
        them on its GSPMD program) the whole compute copy is gathered
        first, unless it is held from an earlier micro batch, and held
        until ``step``."""
        self._ensure_params_resident()
        batch = self._to_device(batch)
        if self.mesh is None:
            loss, grads = self._micro_loss_and_grads(batch)
            self._pending_micro = (loss, grads, loss)
        else:
            self._gather_compute_copy()
            loss, grads = self._micro_loss_and_grads(
                self._rank_rows(batch), params=self._module_params)
            mean = overlap.all_reduce(loss.reshape(1), self.mesh,
                                      mean=True)[0]
            self._pending_micro = (loss, grads, mean)
            loss = mean
        self._moq_batch = batch   # the last micro batch, for eigenvalues
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Accumulate the kept micro gradients in fp32, divided by gas (at
        world size n the rank's local ones: ``step`` exchanges them)."""
        if self._pending_micro is None:
            raise AssertionError("forward() must precede backward()")
        local, grads, mloss = self._pending_micro
        self._pending_micro = None
        gas = self.gradient_accumulation_steps()
        scaled = torch._foreach_div([g.float() for g in grads], gas)
        if self._pending_grads is None:
            self._pending_grads = scaled
            self._accum_loss = local / gas
        else:
            torch._foreach_add_(self._pending_grads, scaled)
            self._accum_loss = self._accum_loss + local / gas
        self.micro_steps += 1
        return loss if loss is not None else mloss

    def step(self):
        """The optimizer step at a gradient-accumulation boundary (at
        ZeRO stage 3 the gathered compute copy is released first)."""
        if self.micro_steps % self.gradient_accumulation_steps() != 0:
            return
        if self._pending_grads is None:
            raise AssertionError("backward() must precede step()")
        if self.mesh is not None:
            self._release_compute_copy()
            metrics = self._world_apply_grads(self._pending_grads,
                                              self._accum_loss)
        elif self._host_runner is not None:
            metrics = self._offload_apply_grads(self._pending_grads,
                                                self._accum_loss)
        else:
            metrics = self._apply_grads(self._pending_grads,
                                        self._accum_loss)
        self._pending_grads = None
        self._accum_loss = None
        self._after_step(metrics)
        self._moq_boundary(self._moq_batch, metrics)
        self._refresh_compute_params()
        self._park_params()

    def _moq_boundary(self, batch, metrics):
        """MoQ at an optimizer-step boundary (engine.py:3321): from
        ``schedule_offset`` on, the quantizer's schedule step and the
        fake quantization of the fp32 masters in place, one kernel launch
        over the table of every eligible JAX leaf; the eigenvalues first
        when the quantizer asks for them. Without fp16 there is no
        overflow, so nothing is read back; with fp16 the flag is, once a
        boundary, as in JAX."""
        q = self.quantizer
        if q is None or self.global_steps < \
                self._config.quantize_training_config.schedule_offset:
            return
        jax_paths = self._moq_jax_paths
        eigenvalues = None
        ev = self.eigenvalue
        if ev is not None and batch is not None and \
                q.any_precision_switch() and \
                self.global_steps % ev.gas_boundary_resolution == 0:
            self._refresh_compute_params()      # this step's weights
            params = dict(zip(self.param_names, self.compute_params))
            eigenvalues = ev.compute_layer_eigenvalues(
                lambda: self._loss_fn(self.module, batch, 1.0).float(),
                params, jax_paths, self.generator)
        overflow = bool(metrics["overflow"]) if self.precision.fp16 \
            else False
        q.quantize_tree(self._named(self.master), jax_paths, overflow,
                        eigenvalues, self.generator)

    # -- ZeRO-Offload and the NVMe parameter tier ----------------------------
    def _make_offload_runner(self, masters):
        """The offload tier (``_make_offload_runner`` :751): the streamed
        tier (state in pinned host memory, the update on the card) for
        ``device: cpu`` with ``stream`` auto or device; the host runner
        (the native SIMD step) for ``stream: "host"`` and for NVMe
        moments."""
        from deepspeed_tpu_torch.runtime.zero.offload import \
            HostOffloadOptimizer
        from deepspeed_tpu_torch.runtime.zero.offload_stream import \
            StreamedOffloadOptimizer
        cfg = self._offload_cfg
        if cfg.device == "cpu" and cfg.stream != "host":
            return StreamedOffloadOptimizer(masters, self.optimizer,
                                            self.device)
        return HostOffloadOptimizer(masters, self.optimizer, cfg,
                                    self._config.aio_config, self.device,
                                    registry=self.metrics)

    def _offload_streamed(self):
        from deepspeed_tpu_torch.runtime.zero.offload_stream import \
            StreamedOffloadOptimizer
        return isinstance(self._host_runner, StreamedOffloadOptimizer)

    def _init_offload_state(self, params, masters=None):
        """The fp32 masters and the moments leave the card (:796); the
        card keeps the compute copy (bf16 with grad_dtype bf16, fp16
        under fp16, as JAX keeps it in the compute dtype, else fp32) and
        no optimizer state. ``masters``: what the tier keeps (a rank's
        slices at world size n), default every leaf whole."""
        self._host_runner = self._make_offload_runner(
            [p.data for p in params] if masters is None else masters)
        self.master = None
        cdt = torch.bfloat16 if self._bf16_grads else \
            torch.float16 if self.precision.fp16 else None
        if cdt is not None:
            for p in params:
                p.data = p.data.to(cdt)
        self.compute_params = params
        self.opt_state = {}

    def _make_param_swapper(self):
        from deepspeed_tpu_torch.runtime.swap_tensor.swapper import \
            PartitionedParamSwapper
        pc = self._config.zero_config.offload_param
        return PartitionedParamSwapper(
            pc.nvme_path, self._config.aio_config,
            pipeline_read=pc.pipeline_read, pipeline_write=pc.pipeline_write,
            buffer_count=pc.buffer_count, registry=self.metrics,
            fsync=pc.fsync)

    def _param_swap_order(self):
        """The order the parked leaves stream back in (``_param_swap_order``
        :849): the leaves outside the layer stack (the embeddings first)
        in model order, then the layers' leaves in order; any
        permutation is correct."""
        def inner(name):
            parts = name.split(".")
            return len(parts) > 2 and parts[1].isdigit()
        names = self.param_names
        return [i for i, n in enumerate(names) if not inner(n)] + \
            [i for i, n in enumerate(names) if inner(n)]

    def _rest_tensors(self):
        """What the parameter tier holds between steps: the compute copy
        when an offload tier keeps the masters, else the fp32 masters
        (the compute copy is their cast)."""
        if self._host_runner is not None:
            return [p.data for p in self.compute_params]
        return self.master

    def _ensure_params_resident(self):
        """Parked parameters come back to the card before anything reads
        them (``_ensure_params_resident`` :886): from NVMe through the
        swapper's read window, or from the pinned arena on its copy
        stream. Without an offload tier they are the masters, and the
        compute copy is made from them again."""
        if not self._params_parked:
            return
        t0 = time.perf_counter()
        if self._param_swapper is not None:
            leaves = self._param_swapper.swap_in_device(
                self.device, order=self._param_swap_order())
        else:
            leaves = self._param_host.unpark()
        if self._host_runner is None:
            self.master = leaves
            if self._bf16_grads:
                leaves = [m.to(torch.bfloat16) for m in leaves]
        for p, t in zip(self.compute_params, leaves):
            p.data = t
        self._params_parked = False
        self.metrics.histogram("swap/unpark_s").observe(
            time.perf_counter() - t0)

    def _park_params(self):
        """The updated parameters to NVMe or the pinned arena and their
        card memory freed (``_park_params`` :908); when the host runner
        wrote them straight to the write-behind queue, only the stale card
        copies go."""
        if self._params_parked or (self._param_swapper is None
                                   and self._param_host is None):
            return
        t0 = time.perf_counter()
        if self._parked_via_push:
            self._parked_via_push = False
        elif self._param_swapper is not None:
            self._param_swapper.swap_out_device(self._rest_tensors())
        else:
            self._param_host.park(self._rest_tensors())
        for p in self.compute_params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        if self._host_runner is None:
            self.master = None
        self._params_parked = True
        self.metrics.histogram("swap/park_s").observe(
            time.perf_counter() - t0)

    def take_swap_stall_s(self):
        """Host seconds blocked on NVMe since the last call, both
        swappers."""
        stall = 0.0
        for sw in (self._param_swapper,
                   getattr(self._host_runner, "swapper", None)):
            if sw is not None:
                stall += sw.take_stall_s()
        return stall

    def _mark(self, stream=None):
        """A timing mark: a CUDA event on ``stream`` (the current one by
        default), with the host clock beside it, or None off the card."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev, time.perf_counter()

    def _offload_train_batch(self, batch):
        """The offload step (``_host_offload_step`` :3012): gradients
        accumulated on the card, then the offload update. With
        ``overlap_comm`` and gas > 1 the host runner takes each micro
        batch's gradients to the host while the next one computes."""
        gas = self.gradient_accumulation_steps()
        m0 = self._mark()
        if gas > 1 and self._config.zero_config.overlap_comm \
                and not self._offload_streamed():
            grads, loss, finite, sq = self._offload_overlapped_grads(
                batch, gas)
        else:
            grads, loss = self._accumulate_grads(batch)
            finite = sq = None
        m1 = self._mark()
        metrics = self._offload_apply_grads(grads, loss, finite, sq)
        if m0 is not None:
            # the update ends when its last state copy reaches the host
            self.offload_marks = (m0, m1, self._mark(
                getattr(self._host_runner, "store_stream", None)))
        return metrics

    def _offload_overlapped_grads(self, batch, gas):
        """``_host_offload_step_overlapped`` (:3047): while the card
        computes micro batch k + 1, micro k's gradients copy to the host
        on a side stream (page-locked staging, two sets) and fold into
        fp32 host accumulators (each times 1/gas). Returns (host
        gradients, loss, finite, squared norm), the norm on the host."""
        inv = 1.0 / gas
        on_card = self.device.type == "cuda"
        acc, losses, pending = None, [], None
        if on_card:
            d2h = torch.cuda.Stream(self.device)
            staging = getattr(self, "_ovl_staging", None)
            if staging is None:
                staging = self._ovl_staging = [
                    [torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                     for p in self.compute_params] for _ in range(2)]

        def fold(item):
            nonlocal acc
            host, landed, _ = item
            if landed is not None:
                landed.synchronize()
            part = [g.float() * inv for g in host]
            if acc is None:
                acc = part
            else:
                for a, g in zip(acc, part):
                    a += g

        with torch.no_grad():
            for k, micro in enumerate(self._split(batch, gas)):
                with torch.enable_grad():
                    loss_k, grads_k = self._micro_loss_and_grads(micro)
                losses.append(loss_k)
                if on_card:
                    d2h.wait_stream(torch.cuda.current_stream(self.device))
                    host = staging[k % 2]
                    with torch.cuda.stream(d2h):
                        for h, g in zip(host, grads_k):
                            h.copy_(g, non_blocking=True)
                        landed = torch.cuda.Event()
                        landed.record(d2h)
                    item = (host, landed, grads_k)
                else:
                    item = (grads_k, None, grads_k)
                if pending is not None:
                    fold(pending)     # overlaps micro k on the card
                pending = item
            fold(pending)
            loss = sum(float(x) for x in losses) / gas
            sq = sum(float(torch.dot(a.view(-1), a.view(-1))) for a in acc)
        finite = math.isfinite(sq) if self.precision.fp16 else True
        return acc, torch.tensor(loss, device=self.device), finite, sq

    def _offload_apply_grads(self, grads, loss, finite=None, sq_norm=None,
                             params=None):
        """The offload update (``_host_apply_grads`` :3114). Under fp16
        the finite check is read back before any gradient leaves the card,
        and an overflow skips the step; the loss-scale inverse and the
        clip coefficient fold into one coefficient, read with the
        gradients. The streamed tier keeps the norm, the coefficient and
        the lr on the card (no read-back); the host runner reads them.
        With the NVMe parameter tier and ``pipeline_write`` the host
        runner's updated leaves go straight to the write-behind queue.
        ``params``: where the updated leaves go (a rank's slices of the
        compute copy at world size n), default the compute copy."""
        dev = self.device
        with torch.no_grad():
            if finite is None:
                finite = bool(prec.grads_finite(grads)) \
                    if self.precision.fp16 else True
            fin_t = torch.tensor(finite, device=dev)
            lr = self._lr()
            if not finite:
                return self._end_update(loss, torch.zeros((), device=dev),
                                        lr, fin_t)
            norm, coef = self._clip_coefficient(grads, sq_norm)
            if params is None:
                params = [p.data for p in self.compute_params]
            if self._offload_streamed():
                self._host_runner.step(grads, params, lr, grad_scale=coef)
            else:
                park = None
                sw = self._param_swapper
                if sw is not None and sw.pipeline_write:
                    park = sw.write_behind
                    self._parked_via_push = True
                self._host_runner.step_streamed(
                    grads, float(lr), grad_scale=float(coef), params=params,
                    park=park)
            return self._end_update(loss, norm, lr, fin_t)

    # -- ZeRO stages 0-3 at world size n ------------------------------------
    def _check_world_path(self):
        """What the n-rank paths do not run: MoQ and its eigenvalues,
        which quantize whole leaves on one rank (the optimizer must be
        elementwise, checked once it is built; the parameter tier at
        world size n is refused by the config)."""
        if self._config.quantize_training_config.enabled:
            raise NotImplementedError(
                f"MoQ (quantize_training, its eigenvalues) at world size "
                f"{self.mesh.size}: not ported ({ROADMAP_MULTI_RANK})")

    def _choose_zero3_path(self):
        """Which path ZeRO stage 3 takes at world size n, as JAX's
        ``_compute_prefetch`` (:1976) decides it: "prefetch" (the layered
        pipeline, ``_build_prefetch_train_fn``) with ``stage3_prefetch``,
        no offload tier, the model's layered-apply contract and no user
        ``loss_fn``; otherwise "gather" (JAX's fused GSPMD stage-3 path,
        ``_init_zero3_gather_state``). None below stage 3 or on one rank.
        ``forward``/``backward``/``step`` and ``eval_batch`` run the gather
        path's step on either, as JAX runs its GSPMD functions there. Rank
        0 logs the choice with JAX's reason."""
        if self.mesh is None or self._config.zero_optimization_stage < 3:
            return None
        zc, model = self._config.zero_config, self.module
        why = None
        if not zc.stage3_prefetch:
            why = "stage3_prefetch is off"
        elif zc.offload_optimizer.enabled:
            why = ("stage3_prefetch: optimizer/pinned-host offload tiers "
                   "stream state through host memory on their own "
                   "schedule; falling back to the fused GSPMD stage-3 "
                   "exchange")
        elif not (getattr(model, "prefetch_layer_subtree", None)
                  and hasattr(model, "prefetch_apply")):
            why = (f"stage3_prefetch: {type(model).__name__} does not "
                   f"expose the layered-apply contract (prefetch_apply + a "
                   f"non-None prefetch_layer_subtree — scanned layers, no "
                   f"MoE, no dropout); falling back to the fused GSPMD "
                   f"exchange")
        elif self._loss_fn_user is not None:
            why = ("stage3_prefetch: a custom loss_fn drives model.apply "
                   "itself, which the layered pipeline cannot intercept; "
                   "falling back to the fused GSPMD exchange")
        path = "prefetch" if why is None else "gather"
        if self.mesh.rank == 0:
            logger.info(f"ZeRO stage 3 at world size {self.mesh.size}: the "
                        f"{path} path" + (f" ({why})" if why else ""))
        return path

    def _prefetch_active(self):
        """True when train_batch runs the stage-3 prefetch pipeline
        (``_prefetch_active`` :1960; at world size 1 nothing is sharded
        and the plain path is the program)."""
        return self.zero3_path == "prefetch"

    def _rank_rows(self, batch):
        """This rank's rows of the global batch: the r-th of n equal
        parts of every leaf's leading dimension."""
        n, r = self.mesh.size, self.mesh.rank
        return _map(lambda x: x[r * (x.shape[0] // n):
                                (r + 1) * (x.shape[0] // n)],
                    self._rows_divisible(batch, n))

    def _init_world_state(self, model_parameters=None):
        """ZeRO stages 0-2 at world size n (``_build_overlap_train_fn``
        :1840), and stage 3's gather path: the model placed and
        initialized as on one rank (the same seed on every rank, so the
        same weights); at stages 0-2 the fp32 masters and the compute copy
        whole, the moments of this rank's slices (``explicit_shard_plan``
        of the moment specs; the persistence threshold is stage 3's alone,
        as in JAX); at stage 3 this rank's shards alone
        (``_init_zero3_gather_state``). Then the bucket plan over the
        leaves in order, and on the card a symmetric heap whose two
        exchange slots hold the largest bucket."""
        mesh, zc = self.mesh, self._config.zero_config
        n = mesh.size
        params = self._place_model(model_parameters)
        shapes = {k: tuple(p.shape) for k, p in zip(self.param_names, params)}
        if self.zero3_path == "gather":
            self._plan = stage3_param_plan(self.module, shapes, n,
                                           zc.param_persistence_threshold)
            self._entries = dict(zip(self.param_names, self._plan))
            self._moment_entries = self._entries
            self._init_zero3_gather_state(params)
        else:
            self._plan = ZeroPartitioner(n, zc.stage).explicit_shard_plan(
                shapes)
            self._entries = {k: None for k in self.param_names}
            self._moment_entries = dict(zip(self.param_names, self._plan))
            if self._offload_cfg.enabled:
                # the rank's slices of the masters and their moments go to
                # the rank's offload tier
                self._init_offload_state(
                    params, self._own_slices([p.data for p in params]))
            else:
                self._keep_masters(params)
                self.opt_state = self.optimizer.init(
                    self._own_slices(self.master))
        self._buckets = self._bucket_plan(shapes.values())
        if mesh.device.type == "cuda":
            SymmetricHeap(mesh, {}, 4 * max(b.padded for b in self._buckets))

    def _bucket_plan(self, shapes, cap=None):
        """The bucket plan over the whole leaves' ``shapes`` in order:
        ``reduce_bucket_size`` elements a bucket (every leaf in one when it
        is not positive), at most ``cap``."""
        zc = self._config.zero_config
        bucket = zc.reduce_bucket_size if zc.reduce_bucket_size > 0 \
            else sum(math.prod(s) for s in shapes)
        if cap is not None:
            bucket = min(bucket, cap)
        return overlap.plan_buckets(list(shapes), bucket, self.mesh.size)

    def _init_zero3_gather_state(self, params):
        """ZeRO stage 3 off the prefetch pipeline at world size n (JAX's
        fused GSPMD stage-3 path, ``_build_jit_fns`` :1474): this rank
        keeps its shards of the stage-3 plan (``stage3_param_plan``) and
        nothing whole: the fp32 masters with their AdamW moments, or the
        offload tier holding both; and the compute copy's shards
        (``_rest``; bf16 with grad_dtype bf16, fp16 under fp16 with an
        offload tier, else fp32). A step gathers the compute copy whole
        into the module's parameters before its first micro batch
        (``_gather_compute_copy``) and releases it after the last
        backward; outside a step the parameters hold no storage."""
        own = [t.clone() for t in self._own_slices([p.data for p in params])]
        cdt = torch.bfloat16 if self._bf16_grads else \
            torch.float16 if (self.precision.fp16
                              and self._offload_cfg.enabled) \
            else torch.float32
        self._rest = [m.to(cdt, copy=True) for m in own]
        if self._offload_cfg.enabled:
            self._host_runner = self._make_offload_runner(own)
            self.master, self.opt_state = None, {}
        else:
            self.master = own
            self.opt_state = self.optimizer.init(self.master)
        self.compute_params = params
        for p in params:
            p.data = torch.empty(0, dtype=cdt, device=self.device)

    def _gather_compute_copy(self):
        """ZeRO stage 3 at world size n: every rank's compute-copy shards
        all-gathered whole into the module's parameters
        (``all_gather_slices`` over the bucket plan, in the compute dtype:
        half the bytes of the fp32 masters under bf16), held until
        ``_release_compute_copy``. Returns the (start, end) timing marks
        on the card, else None; a no-op below stage 3 or when held."""
        if self.zero3_path is None or self._gathered:
            return None
        mesh, r = self.mesh, self.mesh.rank
        m0 = self._mark()
        with torch.no_grad():
            whole = []
            for shard, e in zip(self._rest, self._plan):
                if e is None:
                    whole.append(shard.detach())
                    continue
                shape = list(shard.shape)
                shape[e[0]] *= mesh.size
                t = torch.empty(shape, dtype=shard.dtype, device=shard.device)
                t.narrow(e[0], r * e[1], e[1]).copy_(shard)
                whole.append(t)
            overlap.all_gather_slices(whole, self._plan, mesh, self._buckets)
        for p, t in zip(self._module_params, whole):
            p.data = t
        self._gathered = True
        return None if m0 is None else (m0, self._mark())

    def _release_compute_copy(self):
        """The gathered compute copy let go: the module's parameters hold
        no storage again."""
        if not self._gathered:
            return
        for p in self._module_params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self._gathered = False

    def _own_slices(self, tensors, plan=None):
        """This rank's slice of each leaf (a view; whole where the plan,
        default the engine's, has no entry)."""
        r = self.mesh.rank
        return [t if e is None else t.narrow(e[0], r * e[1], e[1])
                for t, e in zip(tensors, self._plan if plan is None
                                else plan)]

    def _world_apply_grads(self, grads, loss):
        """The n-rank update of stages 0-2 (``_build_overlap_train_fn``'s
        step): ``grads`` are this rank's local gradients (of the loss
        times the loss scale; the list is consumed bucket by bucket) and
        ``loss`` its local loss. The bucket stream gives every rank the
        fp32 mean gradients (JAX's leaves are fp32 after its
        accumulation); of each bucket the rank keeps its leaves' norms,
        their finite flags and its slices, and lets the rest go. Then the
        loss mean, the global norm and the one coefficient that unscales
        and clips, the optimizer step on this rank's slices, and the
        updated slices all-gathered back into the masters. With an
        offload tier the tier steps the slices and writes the rank's
        slices of the compute copy, which are all-gathered in place of the
        masters. On an fp16 overflow every rank sees the same non-finite
        mean and skips. On the card ``world_marks`` keeps CUDA events at
        the step's four points (start, exchanged, updated, gathered); with
        the streamed tier the update ends when its last state copy
        reaches the host, and the gather waits for it. At ZeRO stage 3
        the rank's slices are its shards: the optimizer (or the tier)
        steps the shards of the masters and writes the rank's shards of
        the compute copy, and nothing is gathered (the next step's start
        gathers the compute copy)."""
        mesh = self.mesh
        stage3 = self.zero3_path is not None
        marks = [self._mark()]
        fp16 = self.precision.fp16
        if not isinstance(grads, list):
            grads = list(grads)
        with torch.no_grad():
            norms, own, flags = [None] * len(grads), [None] * len(grads), []
            for bucket, reduced in overlap.bucket_stream(
                    grads, mesh, self._buckets, dtype=torch.float32,
                    consume=True):
                ids = bucket.leaf_ids
                leaves = [reduced[i] for i in ids]
                for i, t in zip(ids, torch._foreach_norm(
                        leaves, 2, dtype=torch.float32)):
                    norms[i] = t
                if fp16:
                    flags.append(prec.grads_finite(leaves))
                for i, t in zip(ids, self._own_slices(
                        leaves, [self._plan[i] for i in ids])):
                    own[i] = t.clone()
                del reduced, leaves
            loss = overlap.all_reduce(loss.reshape(1), mesh, mean=True)[0]
            marks.append(self._mark())
            finite = torch.stack(flags).all() if fp16 else None
            sq_norm = torch.stack(norms).square().sum()
            runner, store = self._host_runner, None
            if runner is None:
                grad_norm, gscale = self._clip_coefficient(own, sq_norm)
                lr = self._lr()
                self.optimizer.step(
                    self.master if stage3 else self._own_slices(self.master),
                    own, self.opt_state, lr, grad_scale=gscale,
                    finite=finite)
                metrics = self._end_update(loss, grad_norm, lr, finite)
                gathered = None if stage3 else self.master
            else:
                # every rank reads the same flag: all skip, or none
                stepped = bool(finite) if fp16 else True
                compute = None if stage3 else \
                    [p.data for p in self.compute_params]
                metrics = self._offload_apply_grads(
                    own, loss, stepped, sq_norm, params=self._rest if stage3
                    else self._own_slices(compute))
                gathered = compute if stepped else None
                store = getattr(runner, "store_stream", None)
            del own
            marks.append(self._mark(store))
            if store is not None:
                torch.cuda.current_stream(self.device).wait_stream(store)
            if gathered is not None:
                overlap.all_gather_slices(gathered, self._plan, mesh,
                                          self._buckets)
            marks.append(self._mark())
        self.world_marks = None if marks[0] is None else marks
        return metrics

    # -- ZeRO-3 with the prefetch pipeline at world size n --------------------
    def _init_zero3_state(self, model_parameters=None):
        """The full model placed and initialized as on one rank, then cut
        to this rank's shards: fp32 masters, AdamW moments and the
        compute copy (in the symmetric heap on the card); the module keeps
        no parameter storage."""
        model, dev, mesh = self.module, self.device, self.mesh
        n, rank = mesh.size, mesh.rank
        zc = self._config.zero_config
        self.master = [p.data for p in self._place_model(model_parameters)]
        cdt = torch.bfloat16 if self._bf16_grads else torch.float32
        sub = model.prefetch_layer_subtree
        leaves = model.prefetch_layer_leaves()
        L = len(getattr(model, sub))
        named = dict(zip(self.param_names, self.master))
        shapes = {}
        for name in self.param_names:
            if not name.startswith(sub + "."):
                shapes[name] = tuple(named[name].shape)
        for leaf in leaves:
            shapes[f"{sub}/{leaf}"] = (L,) + tuple(
                named[f"{sub}.0.{leaf}"].shape)
        zero = ZeroPartitioner(n, 3, zc.param_persistence_threshold)
        zero.layer_stacked_prefixes = (sub,)
        plan = dict(zip(shapes, zero.explicit_shard_plan(
            shapes, zero.param_specs(shapes))))
        self._layer_plan = [plan[f"{sub}/{leaf}"] for leaf in leaves]
        self._outer_names = [k for k in shapes if "/" not in k]
        self._layer_leaves, self._n_layer, self._subtree = leaves, L, sub
        layer_meta = [torch.empty(shapes[f"{sub}/{leaf}"][:1] + tuple(
            s // n if e is not None and d == e[0] else s
            for d, s in enumerate(shapes[f"{sub}/{leaf}"]) if d > 0),
            dtype=cdt, device="meta")
            for leaf, e in zip(leaves, self._layer_plan)]
        self._fused_ids, self._fused_cfg = self._select_fused_matmul_leaves(
            layer_meta, self._layer_plan, zc.stage3_prefetch_gather, n, cdt)
        self._lp = prefetch_lib.build_layer_plan(
            layer_meta, self._layer_plan, n, self._fused_ids)

        # each leaf's (dim, size) in its own coordinates
        self._entries = {}
        for name in self.param_names:
            if name.startswith(sub + "."):
                leaf = name.split(".", 2)[2]
                e = self._lp.plan[leaves.index(leaf)]
            else:
                e = plan[name]
            self._entries[name] = e

        def shard_of(t, e):
            if e is None:
                return t.detach().clone()
            d, size = e
            return t.detach().narrow(d, rank * size, size).clone()
        whole = [tuple(m.shape) for m in self.master]
        self.master = [shard_of(m, self._entries[k])
                       for k, m in zip(self.param_names, self.master)]
        # the gather path's state (forward/backward/step, eval_batch) on
        # the same shards: the plan by leaf and a bucket plan whose
        # buckets fit the heap's slots
        self._plan = [self._entries[k] for k in self.param_names]
        self._buckets = self._bucket_plan(
            whole, cap=max(math.prod(s) for s in whole))
        self.compute_params = self._zero3_compute_copy(cdt)
        self._rest = self.compute_params
        for p in model.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=dev)
        self._moment_entries = self._entries
        self.opt_state = self.optimizer.init(self.master)
        self._record_prefetch_stats(shapes, plan, cdt)
        self._refresh_zero3()
        self._zero3_grads = self._build_prefetch_train_fn()

    def _zero3_compute_copy(self, cdt):
        """The compute copy of every leaf: a rank's sharded leaves in the
        symmetric heap on the card (a layer's packed group contiguous, so
        its gather reads one region a peer; each streamed kernel a region
        of its own), replicated leaves and the CPU's in plain tensors."""
        mesh, n, sub = self.mesh, self.mesh.size, self._subtree
        shard_shapes = {k: tuple(m.shape) for k, m in
                        zip(self.param_names, self.master)}
        if mesh.device.type != "cuda":
            return [m.to(cdt, copy=True).requires_grad_()
                    for m in self.master]
        regions, packed = {}, {}
        for name in self._outer_names:
            if self._entries[name] is not None:
                regions[name] = (shard_shapes[name], cdt)
        for l in range(self._n_layer):
            for g, (_, ids) in enumerate(self._lp.groups):
                names = [f"{sub}.{l}.{self._layer_leaves[j]}" for j in ids]
                numel = sum(math.prod(shard_shapes[k]) for k in names)
                regions[f"{sub}.{l}/packed{g}"] = ((numel,), cdt)
                packed[f"{sub}.{l}/packed{g}"] = names
            for j in self._lp.fused:
                name = f"{sub}.{l}.{self._layer_leaves[j]}"
                regions[name] = (shard_shapes[name], cdt)
        # the largest exchange: a full leaf's fp32 gradient (outer leaves),
        # a layer's backward batch (its streamed leaves' partials and
        # packed groups), or the replicated leaves' all-reduce
        full = [math.prod(m.shape) * (n if self._entries[k] else 1)
                for k, m in zip(self.param_names, self.master)]
        layer = prefetch_lib.layer_exchange_numel(
            self._lp, [shard_shapes[f"{sub}.0.{leaf}"]
                       for leaf in self._layer_leaves], n)
        repl = sum(f for f, k in zip(full, self.param_names)
                   if self._entries[k] is None)
        heap = SymmetricHeap(mesh, regions, 4 * max(
            full + [layer, repl] + [b.padded for b in self._buckets]))
        views = {}
        for region, names in packed.items():
            buf, off = heap.tensor(region), 0
            for k in names:
                m = math.prod(shard_shapes[k])
                views[k] = buf[off:off + m].view(shard_shapes[k])
                off += m
        out = []
        for k, m in zip(self.param_names, self.master):
            if k in views:
                t = views[k]
            elif k in heap.regions:
                t = heap.tensor(k)
            else:
                t = torch.empty(m.shape, dtype=cdt, device=m.device)
            out.append(t.detach().requires_grad_())
        return out

    def _refresh_zero3(self):
        """Masters → the compute copy; on the card a barrier, so that no
        rank's next gather reads a peer's shard before it is written."""
        with torch.no_grad():
            for c, m in zip(self.compute_params, self.master):
                c.copy_(m)
        if self.mesh.heap is not None:
            self.mesh.barrier()

    def _select_fused_matmul_leaves(self, layer_leaves, layer_plan, mode, n,
                                    cdt):
        """Which block leaves stream through the fused kernels under
        ``fused_matmul`` (``_select_fused_matmul_leaves`` :2420): sharded
        [L, in, out] kernels the model declares ``CollectiveDense``-consumed
        whose shard is at least ``collective_matmul.min_shard_bytes``;
        every other sharded leaf rides the packed ring gather. Returns
        (fused ids, CollectiveMatmulConfig), or ((), None)."""
        if mode != "fused_matmul":
            return (), None
        zc = self._config.zero_config
        model = self.module
        paths = tuple(getattr(model, "collective_matmul_paths", ()))
        if not paths:
            logger.info(f"stage3_prefetch_gather=fused_matmul: "
                        f"{type(model).__name__} declares no "
                        f"collective-matmul leaves; the gather is the ring")
            return (), None
        min_bytes = zc.collective_matmul_min_shard_bytes
        itemsize = torch.empty((), dtype=cdt).element_size()
        fused, small, shape = [], 0, 0
        for i, (leaf, e) in enumerate(zip(layer_leaves, layer_plan)):
            if e is None:
                continue
            name = self._layer_leaves[i]
            if leaf.dim() != 3 or not any(
                    name == p or name.endswith("." + p) for p in paths):
                shape += 1
                continue
            if math.prod(leaf.shape[1:]) * itemsize < min_bytes:
                small += 1
                continue
            fused.append(i)
        self.metrics.gauge("comm/zero3_prefetch/fused_leaves").set(len(fused))
        self.metrics.gauge("comm/zero3_prefetch/ring_leaves").set(
            small + shape)
        if not fused:
            logger.info(f"stage3_prefetch_gather=fused_matmul: no layer "
                        f"leaf qualifies ({small} below min_shard_bytes="
                        f"{min_bytes}, {shape} not a streamed kernel); the "
                        f"gather is the ring")
            return (), None
        return tuple(fused), fc.CollectiveMatmulConfig(
            axis_size=n, backend=zc.collective_matmul_backend, mesh=self.mesh)

    def _record_prefetch_stats(self, shapes, plan, cdt):
        """Live gathered-parameter accounting (``_record_prefetch_stats``
        :2497): two layers' gathered leaves, the outer gathers and the
        replicated leaves; a streamed kernel counts its ~2 live chunks."""
        b = torch.empty((), dtype=cdt).element_size()
        n, sub = self.mesh.size, self._subtree
        per_layer = fused = persistent = outer = 0
        for i, leaf in enumerate(self._layer_leaves):
            shape = shapes[f"{sub}/{leaf}"]
            full = math.prod(shape[1:])
            if self._layer_plan[i] is None:
                persistent += full * shape[0]
            elif i in self._fused_ids:
                fused += 2 * (full // n)
            else:
                per_layer += full
        for name in self._outer_names:
            full = math.prod(shapes[name])
            if plan[name] is None:
                persistent += full
            else:
                outer += full
        self._prefetch_stats = {
            "live_param_elements": 2 * per_layer + outer + persistent + fused,
            "live_param_bytes": (2 * per_layer + outer + persistent
                                 + fused) * b,
            "per_layer_gather_bytes": per_layer * b,
            "fused_stream_bytes": fused * b,
            "fused_leaves_per_layer": len(self._fused_ids),
            "outer_gather_bytes": outer * b,
            "persistent_replicated_bytes": persistent * b,
            "layers": self._n_layer}
        max_live = self._config.zero_config.max_live_parameters
        if max_live and self._prefetch_stats["live_param_elements"] > max_live:
            logger.warning(
                f"stage3_prefetch: the 2-layer double buffer holds "
                f"{self._prefetch_stats['live_param_elements']} full-"
                f"parameter elements live, above stage3_max_live_parameters"
                f"={max_live}")

    def prefetch_live_param_stats(self):
        """The prefetch pipeline's live-parameter accounting (``:2024``):
        peak gathered elements and bytes and their parts; None at world
        size 1."""
        return getattr(self, "_prefetch_stats", None)

    def _build_prefetch_train_fn(self):
        """The n-rank step's gradients (``_build_prefetch_train_fn``
        :2033): ``fn(batch) -> (grads, loss, squared norm, finite)``, fp32
        gradients of this rank's shards (SUMS over the ranks scaled by
        1/n) and of the replicated leaves (all-reduced means), the loss
        the global mean, and under fp16 the global finite flag (None
        otherwise). Each rank takes its rows of the global batch and
        accumulates its micro batches as one rank does
        (``_accumulate_grads``); the caller updates the shards."""
        mesh, model = self.mesh, self.module
        n, sub, L = mesh.size, self._subtree, self._n_layer
        mode = self._config.zero_config.stage3_prefetch_gather
        names, entries = self.param_names, self._entries
        outer = self._outer_names
        scan = prefetch_lib.make_prefetched_scan
        gathered = {k: prefetch_lib.make_gathered_param(entries[k], mesh,
                                                        mode)
                    for k in outer if entries[k] is not None}
        sharded = [i for i, k in enumerate(names) if entries[k] is not None]
        repl = [i for i, k in enumerate(names) if entries[k] is None]

        def micro_loss(micro, keep):
            p = dict(zip(names, self.compute_params))
            view = {k: gathered[k](p[k]) if k in gathered else p[k]
                    for k in outer}
            view[sub] = [[p[f"{sub}.{l}.{leaf}"]
                          for leaf in self._layer_leaves] for l in range(L)]

            def run_layers(body, x, h_shards):
                return scan(body, self._layer_plan, mesh, mode,
                            fused_ids=self._fused_ids,
                            fused_cfg=self._fused_cfg)(x, h_shards)
            if isinstance(micro, dict) and "input_ids" in micro:
                ids, labels = micro["input_ids"], micro.get(
                    "labels", micro["input_ids"])
            else:
                ids = labels = micro
            return model.prefetch_apply(view, ids, run_layers,
                                        keep_prob=keep, labels=labels)

        fp16 = self.precision.fp16

        def fn(batch):
            grads, loss = self._accumulate_grads(self._rank_rows(batch),
                                                 micro_loss)
            with torch.no_grad():
                acc = [g.float() for g in grads]
                for i in sharded:
                    acc[i] = acc[i] * (1.0 / n)
                for i, g in zip(repl, overlap.allreduce_leaves(
                        [acc[i] for i in repl], mesh)):
                    acc[i] = g
                zero = torch.zeros((), device=self.device)
                shard_sq = sum((acc[i].square().sum() for i in sharded), zero)
                # the ranks whose shard or replicated gradients are not
                # finite, summed with the loss and the shard norms: under
                # fp16 every rank skips together (JAX's pmin, :2359)
                bad = (~prec.grads_finite(acc)).float() if fp16 else zero
                tot = overlap.all_reduce(torch.stack([loss, shard_sq, bad]),
                                         mesh)
                repl_sq = sum((acc[i].square().sum() for i in repl), zero)
            finite = tot[2] == 0 if fp16 else None
            return acc, tot[0] / n, tot[1] + repl_sq, finite
        return fn

    def _rows_divisible(self, batch, n):
        for x in _leaves(batch):
            if x.shape[0] % n:
                raise AssertionError(
                    f"train_batch got leading dim {x.shape[0]} not "
                    f"divisible by the {n} ranks")
        return batch

    def gather_master(self):
        """Every leaf's fp32 master, gathered whole, by name, on the CPU
        (collective on the ZeRO-3 path and with an offload tier at world
        size n: every rank calls it; the device optimizer at stages 0-2
        holds the masters whole)."""
        out = {}
        if self.mesh is None:
            self._ensure_params_resident()
        runner = self._host_runner
        masters = runner.master_leaves() if runner is not None \
            else self.master
        for k, m in zip(self.param_names, masters):
            if self.mesh is None:
                full = m
            elif runner is not None:
                e = self._moment_entries[k]
                full = m if e is None else torch.cat(
                    self.mesh.all_gather(m.cpu()), dim=e[0])
            else:
                e = self._entries[k]
                full = m if e is None else prefetch_lib.gather_leaf(
                    m, e, self.mesh)
            out[k] = full.detach().cpu()
        return out

    def close(self):
        """Free the symmetric heap (collective at world size n > 1) and
        drop the step function, whose closure refers back to the engine
        (the cycle would keep the shards alive until a collection); on
        one rank, free the offload tier's host state and swap files (at
        world size n each rank its own)."""
        if self._host_runner is not None:
            self._host_runner.close()
            self._host_runner = None
        if self.mesh is None:
            if self._param_swapper is not None:
                self._param_swapper.release()
                self._param_swapper = None
            if self._param_host is not None:
                self._param_host.close()
                self._param_host = None
            return
        self._zero3_grads = None
        self._release_compute_copy()
        if self.mesh.heap is not None:
            if self._prefetch_active():
                self.compute_params = self._rest = None
            self.mesh.heap.close()


    def zero_grad(self):
        self._pending_grads = None

    def eval_batch(self, batch):
        """The model's output (logits) for the batch's inputs; at world
        size n the whole batch's on every rank (``_jit_eval`` :1610): the
        parameters are replicated at stages 0-2, and at stage 3 the
        compute copy is gathered for the call and released after it
        (unless a ``forward`` holds it)."""
        self._ensure_params_resident()
        batch = self._to_device(batch)
        if isinstance(batch, dict):
            x = batch.get("input_ids", batch.get("inputs", batch.get("x")))
            x = next(iter(batch.values())) if x is None else x
        elif isinstance(batch, (tuple, list)):
            x = batch[0]
        else:
            x = batch
        held = self._gathered
        self._gather_compute_copy()
        try:
            with torch.no_grad():
                return self.module(x)
        finally:
            if not held:
                self._release_compute_copy()

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        return DeepSpeedDataLoader(
            dataset, batch_size=batch_size
            or self.train_micro_batch_size_per_gpu(),
            collate_fn=collate_fn or self.collate_fn, seed=self._config.seed)

    # -- checkpoints ---------------------------------------------------------
    def _named(self, tensors):
        return dict(zip(self.param_names, tensors))

    def _bridge(self):
        """The model's weight bridge to the JAX tree, which checkpoints
        are written in."""
        if not (hasattr(self.module, "jax_tree")
                and hasattr(self.module, "from_jax_tree")):
            raise NotImplementedError(
                f"checkpoints need a model with the JAX weight bridge "
                f"(jax_tree / from_jax_tree, as models/gpt2.py has); "
                f"{type(self.module).__name__} has none")
        return self.module

    def _tree(self, tensors):
        """Port tensors → the JAX-named tree, through the model's bridge."""
        return self._bridge().jax_tree(
            self._named([t.detach().cpu() for t in tensors]))

    def _untree(self, tree):
        named = self._bridge().from_jax_tree(tree)
        return [named[n] for n in self.param_names]

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Write the tag's directory (``engine.py:3891``); at world size n
        collective, each rank writing the pieces it owns."""
        self._ensure_params_resident()
        tag = tag or f"global_step{self.global_steps}"
        self.skipped_steps = int(self.skipped_steps_t)
        extra = {"global_steps": self.global_steps,
                 "micro_steps": self.micro_steps,
                 "global_samples": self.global_samples,
                 "skipped_steps": self.skipped_steps,
                 "client_state": client_state or {}}
        if isinstance(self.lr_scheduler, _Schedule):
            extra["lr_scheduler"] = self.lr_scheduler.state_dict()
        if self.mesh is not None:
            ckpt.save_checkpoint(save_dir, tag, self._world_state(), extra,
                                 save_latest=save_latest,
                                 zero_stage=self.zero_optimization_stage(),
                                 mesh=self.mesh)
            return True
        if self._host_runner is not None:
            # the fp32 masters and moments from the host, not the compute
            # copy on the card (engine.py:3900)
            masters = self._host_runner.master_leaves()
            sd = self._host_runner.state_dict()
            opt = {"step": torch.tensor(sd["step"], dtype=torch.int32),
                   "exp_avg": self._tree(sd["exp_avg"]),
                   "exp_avg_sq": self._tree(sd["exp_avg_sq"])}
        else:
            masters = self.master
            opt = {k: (self._tree(v) if k in
                       self.optimizer.param_like_state_fields else v.cpu())
                   for k, v in self.opt_state.items()}
        ckpt.save_checkpoint(save_dir, tag, {
            "params": self._tree(masters), "opt_state": opt,
            "scaler": {k: v.cpu() for k, v in self.scaler.items()},
            "global_step": self.global_step_t.cpu(),
            "skipped_steps": self.skipped_steps_t.cpu()}, extra,
            save_latest=save_latest,
            zero_stage=self.zero_optimization_stage())
        return True

    def load_checkpoint(self, load_dir, tag=None, load_module_only=False,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """(tag, client_state), or (None, {}) when nothing is found. At
        world size n each rank reads the windows it holds from the union
        of the shard files, whatever world wrote them."""
        want_opt = load_optimizer_states and not load_module_only
        if self.mesh is not None:
            opened = ckpt.open_checkpoint(load_dir, tag)
            if opened is None:
                logger.warning(f"Unable to find checkpoint in {load_dir}, "
                               f"tag={tag}")
                return None, {}
            reader, extra = opened
            try:
                state = self._adopt_world_state(reader, want_opt)
            finally:
                reader.close()
        else:
            loaded = ckpt.load_checkpoint(load_dir, tag,
                                          load_optimizer=want_opt)
            if loaded is None:
                logger.warning(f"Unable to find checkpoint in {load_dir}, "
                               f"tag={tag}")
                return None, {}
            state, extra = loaded
            self._adopt_loaded_state(state, want_opt)
        return self._adopt_counters(state, extra, load_lr_scheduler_states,
                                    tag or ckpt.read_latest_tag(load_dir))

    def _adopt_loaded_state(self, state, want_opt):
        """One rank: the loaded trees (``ckpt.load_checkpoint``) into the
        masters, the optimizer state and the compute copy."""
        dev = self.device
        # the loaded weights replace resident ones; the next park writes
        # the tier from them (engine.py:4040)
        self._ensure_params_resident()
        if self._host_runner is not None:
            self._adopt_loaded_state_offload(state, want_opt)
        else:
            with torch.no_grad():
                for m, t in zip(self.master, self._untree(state["params"])):
                    m.copy_(t)
                if want_opt:
                    for k, v in state["opt_state"].items():
                        if k in self.optimizer.param_like_state_fields:
                            for cur, t in zip(self.opt_state[k],
                                              self._untree(v)):
                                cur.copy_(t)
                        else:
                            self.opt_state[k] = v.to(dev)
                self._refresh_compute_params()

    def _adopt_counters(self, state, extra, load_lr, tag):
        """The scaler, the device and host counters and the scheduler
        from a loaded checkpoint; returns (tag, client_state)."""
        dev = self.device
        self.scaler = {k: v.to(dev) for k, v in state["scaler"].items()}
        self.global_step_t = state["global_step"].to(dev)
        self.skipped_steps_t = state["skipped_steps"].to(dev)
        self.global_steps = extra.get("global_steps", 0)
        self.micro_steps = extra.get("micro_steps", 0)
        self.global_samples = extra.get("global_samples", 0)
        self.skipped_steps = extra.get("skipped_steps", 0)
        if load_lr and isinstance(self.lr_scheduler, _Schedule) \
                and "lr_scheduler" in extra:
            self.lr_scheduler.load_state_dict(extra["lr_scheduler"])
        return tag, extra.get("client_state", {})

    # -- checkpoints at world size n (``checkpointing.py:280``, ``:369``) ----
    def _world_pieces(self, tensors, entries):
        """This rank's pieces of ``tensors`` (what the rank holds of each
        leaf: the whole leaf where its entry is None, else its shard
        ``(dim, size)``) as the JAX-named tree of ``ckpt.Pieces``: a
        shard's window at its offset in the global leaf, a whole leaf
        from rank 0 alone (JAX's replica 0); a layer of a layer-stacked
        leaf is its [1, ...] window."""
        n, r = self.mesh.size, self.mesh.rank
        paths = self._bridge().jax_paths()
        depth = {}
        for path, layer in paths.values():
            if layer is not None:
                depth[path] = max(depth.get(path, 0), layer + 1)
        root = {}
        for name, t in zip(self.param_names, tensors):
            path, layer = paths[name]
            e = entries[name]
            if e is None and r != 0:
                continue
            shape, start = list(t.shape), [0] * t.dim()
            if e is not None:
                shape[e[0]], start[e[0]] = e[1] * n, r * e[1]
            win = t.detach().cpu()
            if layer is not None:
                shape, start = [depth[path]] + shape, [layer] + start
                win = win[None]
            node = root
            for key in path[:-1]:
                node = node.setdefault(key, {})
            leaf = node.setdefault(path[-1], ckpt.Pieces(tuple(shape),
                                                         t.dtype))
            leaf.windows.append((tuple(start), win))
        return root

    def _world_state(self):
        """The state trees this rank writes: the masters' and the moments'
        pieces (the moments cut as the moment specs cut them; with an
        offload tier the masters too, from the tier's slices); the
        optimizer's counters, the scaler and the step counters from
        rank 0 alone."""
        runner = self._host_runner
        if runner is not None:
            sd = runner.state_dict()
            small = {"step": torch.tensor(sd["step"], dtype=torch.int32)}
            opt = {k: self._world_pieces(sd[k], self._moment_entries)
                   for k in ("exp_avg", "exp_avg_sq")}
            params = self._world_pieces(runner.master_leaves(),
                                        self._moment_entries)
        else:
            like = self.optimizer.param_like_state_fields
            small = {k: v.cpu() for k, v in self.opt_state.items()
                     if k not in like}
            opt = {k: self._world_pieces(v, self._moment_entries)
                   for k, v in self.opt_state.items() if k in like}
            params = self._world_pieces(self.master, self._entries)
        state = {"params": params, "opt_state": opt}
        if self.mesh.rank == 0:
            opt.update(small)
            state.update(scaler={k: v.cpu() for k, v in self.scaler.items()},
                         global_step=self.global_step_t.cpu(),
                         skipped_steps=self.skipped_steps_t.cpu())
        return state

    def _adopt_world_state(self, reader, want_opt):
        """Each leaf's window this rank holds (whole, or its shard) read
        from ``reader`` into the masters and, with ``want_opt``, the
        moments, the compute copy refreshed; the checkpoint's layer
        layout (stacked or unrolled) from its tree. Leaves are read path
        by path, so a stacked leaf's pieces load once. Returns the small
        trees (scaler, counters)."""
        r, bridge = self.mesh.rank, self._bridge()
        paths = bridge.jax_paths(bridge.scan_tree(
            reader.paths("model_states")["params"]))
        order = sorted(range(len(self.param_names)),
                       key=lambda i: paths[self.param_names[i]][0])

        def fill(prefix, tensors, entries):
            for i in order:
                name, t = self.param_names[i], tensors[i]
                path, layer = paths[name]
                start, stop = [0] * t.dim(), list(t.shape)
                e = entries[name]
                if e is not None:
                    start[e[0]], stop[e[0]] = r * e[1], (r + 1) * e[1]
                if layer is not None:
                    start, stop = [layer] + start, [layer + 1] + stop
                w = reader.window(f"{prefix}/{'/'.join(path)}", start, stop)
                t.copy_(w[0] if layer is not None else w)

        like = self.optimizer.param_like_state_fields
        with torch.no_grad():
            if self._host_runner is not None:
                self._adopt_world_offload(reader, want_opt, fill)
            else:
                fill("model_states:params", self.master, self._entries)
                for k in self.opt_state if want_opt else ():
                    if k in like:
                        fill(f"optim_states:opt_state/{k}",
                             self.opt_state[k], self._moment_entries)
                    else:
                        self.opt_state[k] = reader.read(
                            f"optim_states:opt_state/{k}").to(self.device)
                self._refresh_compute_params()
        small = reader.paths("optim_states")
        return {"scaler": {k: reader.read(f"optim_states:scaler/{k}")
                           for k in small["scaler"]},
                "global_step": reader.read("optim_states:global_step"),
                "skipped_steps": reader.read("optim_states:skipped_steps")}

    def _adopt_world_offload(self, reader, want_opt, fill):
        """World size n with an offload tier: every leaf's master read
        whole (the compute copy is its cast, the tier takes the rank's
        slices of it; at stage 3 the rank's shards alone, for the tier
        and the compute copy's shards) and, with ``want_opt``, the rank's
        moment slices and Adam's count into the tier (``fill(prefix,
        tensors, entries)`` reads windows into CPU tensors)."""
        runner = self._host_runner
        if self.zero3_path is not None:
            whole = None
            mine = [torch.empty(t.shape) for t in self._rest]
            fill("model_states:params", mine, self._entries)
        else:
            whole = [torch.empty(p.shape) for p in self.compute_params]
            fill("model_states:params", whole, self._entries)
            mine = self._own_slices(whole)
        runner.load_master_leaves(mine)
        if want_opt:
            sd = {"step": int(reader.read("optim_states:opt_state/step"))}
            for k in ("exp_avg", "exp_avg_sq"):
                sd[k] = [torch.empty(t.shape) for t in mine]
                fill(f"optim_states:opt_state/{k}", sd[k],
                     self._moment_entries)
            runner.load_state_dict(sd)
        for p, m in zip(self._rest if whole is None else
                        [p.data for p in self.compute_params],
                        mine if whole is None else whole):
            p.copy_(m)

    def _adopt_loaded_state_offload(self, state, want_opt):
        """``_adopt_loaded_state_offload`` (:4282): the loaded fp32
        masters (and, when loaded, the moments and Adam's count) into the
        offload tier, and the compute copy made from the masters on the
        card; a parked tier is marked resident on the loaded weights (the
        next park rewrites its files)."""
        masters = self._untree(state["params"])
        runner = self._host_runner
        runner.load_master_leaves(masters)
        opt = state.get("opt_state") or {}
        if want_opt and opt:
            runner.load_state_dict({
                "step": int(opt["step"]),
                "exp_avg": self._untree(opt["exp_avg"]),
                "exp_avg_sq": self._untree(opt["exp_avg_sq"])})
        with torch.no_grad():
            for p, m in zip(self.compute_params, masters):
                p.data = m.to(self.device, p.dtype)
        self._params_parked = False
        self._parked_via_push = False


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map_many(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_many(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_map_many(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    return fn(*trees)
