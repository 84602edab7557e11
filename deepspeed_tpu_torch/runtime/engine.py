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
"""

import inspect
import logging
import os

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import (ROADMAP_MULTI_RANK,
                                               DeepSpeedConfig)
from deepspeed_tpu_torch.models.gpt2 import lm_loss
from deepspeed_tpu_torch.ops.adam import FusedAdam
from deepspeed_tpu_torch.ops.cuda import ROADMAP_SECOND_ORDER
from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.runtime import precision as prec
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue
from deepspeed_tpu_torch.runtime.lr_schedules import (_Schedule,
                                                      get_lr_schedule)
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop
from deepspeed_tpu_torch.runtime.quantize import Quantizer
from deepspeed_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("deepspeed_tpu_torch")


def _build_optimizer(name, params_dict):
    p = dict(params_dict or {})
    name = (name or "adam").lower()
    if name not in ("adam", "adamw", "fusedadam"):
        raise ValueError(f"Unknown optimizer type {name}")
    adam_w = True if name == "adamw" else p.pop("adam_w_mode", True)
    opt = FusedAdam(lr=p.pop("lr", 1e-3),
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
                 seed=None):
        world = _world_size()
        if world > 1:
            raise NotImplementedError(
                f"deepspeed_tpu_torch trains on one rank; world size is "
                f"{world} ({ROADMAP_MULTI_RANK})")
        self.device = resolve_device(device)
        self.module = model
        self.collate_fn = collate_fn
        self._loss_fn_user = loss_fn
        self._config = DeepSpeedConfig(config, world_size=1)
        self.precision = prec.PrecisionConfig.from_ds_config(self._config)

        if optimizer is None:
            self.optimizer = _build_optimizer(self._config.optimizer_name,
                                              self._config.optimizer_params)
        elif isinstance(optimizer, TorchOptimizer):
            self.optimizer = optimizer
        else:
            raise TypeError("optimizer must be a deepspeed_tpu_torch "
                            "TorchOptimizer (ops/adam.py FusedAdam)")
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
        self._init_state(model_parameters)
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
    def _init_state(self, model_parameters=None):
        """Place the model on the device: its own weights, the given
        ``model_parameters`` (a state dict), or — for a model made on the
        meta device — fresh ones from ``reset_parameters`` and a seeded
        generator, as the JAX engine calls ``model.init``. Then the fp32
        masters, the optimizer state and the scaler."""
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
        for n, p in zip(self.param_names, params):
            if p.dtype != torch.float32:
                raise ValueError(f"parameter {n} is {p.dtype}: the engine "
                                 f"keeps fp32 master parameters")
        self.master = [p.data for p in params]
        self._bf16_grads = self._config.grad_dtype == "bf16"
        if self._bf16_grads:
            for p in params:
                p.data = p.data.to(torch.bfloat16)
        self.compute_params = params
        self.opt_state = self.optimizer.init(self.master)
        self.scaler = prec.init_scaler_state(self.precision, dev)
        self.global_step_t = torch.zeros((), dtype=torch.int32, device=dev)
        self.skipped_steps_t = torch.zeros((), dtype=torch.int32, device=dev)

    def _refresh_compute_params(self):
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

    def _micro_loss_and_grads(self, micro_batch):
        """(loss, grads) of one micro batch: grads of loss × loss scale,
        in the compute parameters' dtype (bf16 with grad_dtype bf16)."""
        if self._loss_fn is None:
            self._loss_fn = self._resolve_loss_fn()
        pld = self.progressive_layer_drop
        keep = 1.0 if pld is None else pld.theta_at(self.global_step_t)
        loss = self._loss_fn(self.module, micro_batch, keep)
        grads = torch.autograd.grad(
            (loss.float() * self.scaler["loss_scale"]), self.compute_params,
            allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, self.compute_params)]
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

    def _accumulate_grads(self, batch):
        gas = self.gradient_accumulation_steps()
        if gas == 1:
            loss, grads = self._micro_loss_and_grads(batch)
            return grads, loss
        acc_dtype = torch.bfloat16 if self._config.grad_accum_dtype == "bf16" \
            else torch.float32
        acc, acc_loss = None, torch.zeros((), device=self.device)
        for micro in self._split(batch, gas):
            loss, grads = self._micro_loss_and_grads(micro)
            part = torch._foreach_div([g.to(acc_dtype) for g in grads], gas)
            if acc is None:
                acc = part
            else:
                torch._foreach_add_(acc, part)
            acc_loss = acc_loss + loss / gas
        return acc, acc_loss

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

    def _apply_grads(self, grads, loss):
        """Unscale, clip, step, scaler update in one pass of the update
        (engine.py:1394); the caller refreshes the compute copy. On an
        fp16 overflow the masters and the optimizer state keep their
        values (``_tree_where``): the optimizer folds the finite flag into
        its update."""
        with torch.no_grad():
            inv = 1.0 / self.scaler["loss_scale"]
            finite = prec.grads_finite(grads) if self.precision.fp16 \
                else None
            norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
            grad_norm = torch.stack(norms).square().sum().sqrt() * inv \
                if norms else torch.zeros((), device=self.device)
            gscale = inv
            clip = self._config.gradient_clipping
            if clip and clip > 0:
                gscale = inv * torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
            lr = self._lr()
            self.optimizer.step(self.master, grads, self.opt_state, lr,
                                grad_scale=gscale, finite=finite)
            if finite is None:
                finite = torch.ones((), dtype=torch.bool, device=self.device)
            self.scaler = prec.update_scaler(self.scaler, self.precision,
                                             finite)
            self.global_step_t = self.global_step_t + finite.int()
            self.skipped_steps_t = self.skipped_steps_t + (~finite).int()
        return {"loss": loss, "grad_norm": grad_norm, "lr": lr,
                "overflow": ~finite, "loss_scale": self.scaler["loss_scale"]}

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
        grads, loss = self._accumulate_grads(batch)
        metrics = self._apply_grads(grads, loss)
        del grads
        self.micro_steps += self.gradient_accumulation_steps()
        self._after_step(metrics)
        self._moq_boundary(batch, metrics)
        self._refresh_compute_params()
        return metrics["loss"]

    def forward(self, batch):
        """Loss and gradients of one micro batch, kept for
        ``backward``/``step`` (engine.py:3229)."""
        batch = self._to_device(batch)
        loss, grads = self._micro_loss_and_grads(batch)
        self._pending_micro = (loss, grads)
        self._moq_batch = batch   # the last micro batch, for eigenvalues
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Accumulate the kept micro gradients in fp32, divided by gas."""
        if self._pending_micro is None:
            raise AssertionError("forward() must precede backward()")
        mloss, grads = self._pending_micro
        self._pending_micro = None
        gas = self.gradient_accumulation_steps()
        scaled = torch._foreach_div([g.float() for g in grads], gas)
        if self._pending_grads is None:
            self._pending_grads = scaled
            self._accum_loss = mloss / gas
        else:
            torch._foreach_add_(self._pending_grads, scaled)
            self._accum_loss = self._accum_loss + mloss / gas
        self.micro_steps += 1
        return loss if loss is not None else mloss

    def step(self):
        """The optimizer step at a gradient-accumulation boundary."""
        if self.micro_steps % self.gradient_accumulation_steps() != 0:
            return
        if self._pending_grads is None:
            raise AssertionError("backward() must precede step()")
        metrics = self._apply_grads(self._pending_grads, self._accum_loss)
        self._pending_grads = None
        self._accum_loss = None
        self._after_step(metrics)
        self._moq_boundary(self._moq_batch, metrics)
        self._refresh_compute_params()

    def _moq_boundary(self, batch, metrics):
        """MoQ at an optimizer-step boundary (engine.py:3321): from
        ``schedule_offset`` on, the quantizer's schedule step and the
        fake quantization of the fp32 masters in place, one kernel launch
        a JAX leaf; the eigenvalues first when the quantizer asks for
        them. Without fp16 there is no overflow, so nothing is read back;
        with fp16 the flag is, once a boundary, as in JAX."""
        q = self.quantizer
        if q is None or self.global_steps < \
                self._config.quantize_training_config.schedule_offset:
            return
        jax_paths = self.module.jax_paths() \
            if hasattr(self.module, "jax_paths") else None
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

    def zero_grad(self):
        self._pending_grads = None

    def eval_batch(self, batch):
        """The model's output (logits) for the batch's inputs."""
        batch = self._to_device(batch)
        if isinstance(batch, dict):
            x = batch.get("input_ids", batch.get("inputs", batch.get("x")))
            x = next(iter(batch.values())) if x is None else x
        elif isinstance(batch, (tuple, list)):
            x = batch[0]
        else:
            x = batch
        with torch.no_grad():
            return self.module(x)

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
        tag = tag or f"global_step{self.global_steps}"
        self.skipped_steps = int(self.skipped_steps_t)
        extra = {"global_steps": self.global_steps,
                 "micro_steps": self.micro_steps,
                 "global_samples": self.global_samples,
                 "skipped_steps": self.skipped_steps,
                 "client_state": client_state or {}}
        if isinstance(self.lr_scheduler, _Schedule):
            extra["lr_scheduler"] = self.lr_scheduler.state_dict()
        opt = {k: (self._tree(v) if k in
                   self.optimizer.param_like_state_fields else v.cpu())
               for k, v in self.opt_state.items()}
        ckpt.save_checkpoint(save_dir, tag, {
            "params": self._tree(self.master), "opt_state": opt,
            "scaler": {k: v.cpu() for k, v in self.scaler.items()},
            "global_step": self.global_step_t.cpu(),
            "skipped_steps": self.skipped_steps_t.cpu()}, extra,
            save_latest=save_latest,
            zero_stage=self.zero_optimization_stage())
        return True

    def load_checkpoint(self, load_dir, tag=None, load_module_only=False,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """(tag, client_state), or (None, {}) when nothing is found."""
        want_opt = load_optimizer_states and not load_module_only
        loaded = ckpt.load_checkpoint(load_dir, tag, load_optimizer=want_opt)
        if loaded is None:
            logger.warning(f"Unable to find checkpoint in {load_dir}, "
                           f"tag={tag}")
            return None, {}
        state, extra = loaded
        dev = self.device
        with torch.no_grad():
            for m, t in zip(self.master, self._untree(state["params"])):
                m.copy_(t)
            if want_opt:
                for k, v in state["opt_state"].items():
                    if k in self.optimizer.param_like_state_fields:
                        for cur, t in zip(self.opt_state[k], self._untree(v)):
                            cur.copy_(t)
                    else:
                        self.opt_state[k] = v.to(dev)
            self._refresh_compute_params()
        self.scaler = {k: v.to(dev) for k, v in state["scaler"].items()}
        self.global_step_t = state["global_step"].to(dev)
        self.skipped_steps_t = state["skipped_steps"].to(dev)
        self.global_steps = extra.get("global_steps", 0)
        self.micro_steps = extra.get("micro_steps", 0)
        self.global_samples = extra.get("global_samples", 0)
        self.skipped_steps = extra.get("skipped_steps", 0)
        if load_lr_scheduler_states and isinstance(self.lr_scheduler,
                                                   _Schedule) \
                and "lr_scheduler" in extra:
            self.lr_scheduler.load_state_dict(extra["lr_scheduler"])
        return tag or ckpt.read_latest_tag(load_dir), \
            extra.get("client_state", {})


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
