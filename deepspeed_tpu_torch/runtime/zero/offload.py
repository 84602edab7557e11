"""ZeRO-Offload's host runner: the optimizer step on the host's cores.

Port of ``deepspeed_tpu/runtime/zero/offload.py``: the card computes the
loss and the gradients in the compute dtype; the fp32 masters and the
Adam moments live in host memory (``device: cpu`` with ``stream:
"host"``) or the moments on NVMe (``device: nvme``, through
``OptimizerStateSwapper``); the step runs in the native SIMD library
(``csrc/cpu_adam.cpp``), and the updated parameters go back to the card
in the compute dtype. The moments are fp32 whatever ``moment_dtype``
says (the SIMD step and the swapper work on fp32).

The step, ``step_streamed``, overlaps three stages: each gradient leaf
copies to a page-locked staging slot on a side stream, the SIMD step
runs on it as soon as it lands (the gradient read in its wire dtype with
the unscale and clip coefficient folded in, and the bf16 copy of the
updated leaf written in the same pass), and that copy goes back to the
card at once on another stream, while the next leaves land and step. A ring of
``slots`` staging slots bounds the page-locked memory. With NVMe
moments, leaf i + 1's moments are read while leaf i steps.

Where the JAX package falls back to numpy when the native library does
not load, the port raises.
"""

import logging
import time

import torch

from deepspeed_tpu_torch.config.config import ROADMAP_LAMB_SGD
from deepspeed_tpu_torch.ops.adam import FusedAdam
from deepspeed_tpu_torch.ops.native import cpu_adam as native_cpu_adam

logger = logging.getLogger("deepspeed_tpu_torch")

# page-locked staging slots of the largest leaf, for gradients in and
# parameters out
SLOTS = 4


class HostOffloadOptimizer:
    """fp32 masters and Adam moments on the host; the native step."""

    def __init__(self, masters, optimizer, offload_cfg, aio_cfg=None,
                 device="cpu", registry=None):
        if not isinstance(optimizer, FusedAdam):
            raise NotImplementedError(
                f"the host offload runner steps Adam/AdamW; "
                f"{type(optimizer).__name__} is not ported "
                f"({ROADMAP_LAMB_SGD})")
        self.optimizer = optimizer
        if optimizer.moment_dtype != "fp32":
            logger.warning(
                "moment_dtype=%s ignored by the host offload runner: its "
                "moments are fp32 in host memory or on NVMe",
                optimizer.moment_dtype)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.native = native_cpu_adam.load()
        self.device_nvme = offload_cfg.device == "nvme"
        self.step_count = 0
        self.shapes = [tuple(m.shape) for m in masters]
        self.master = [m.detach().to("cpu", torch.float32, copy=True)
                       .contiguous() for m in masters]
        self.swapper = None
        if self.device_nvme:
            from deepspeed_tpu_torch.runtime.swap_tensor.swapper import \
                OptimizerStateSwapper
            self.swapper = OptimizerStateSwapper(
                offload_cfg.nvme_path, aio_cfg,
                pipeline_write=offload_cfg.pipeline_write,
                buffer_count=offload_cfg.buffer_count, registry=registry)
            for i, shape in enumerate(self.shapes):
                self.swapper.init_state(i, shape)
            self.m = self.v = None
        else:
            self.m = [torch.zeros_like(x) for x in self.master]
            self.v = [torch.zeros_like(x) for x in self.master]
        self._slots = None
        # host seconds in the native step, in the last step (telemetry)
        self.last_adam_s = 0.0

    @property
    def host_bytes(self):
        n = sum(m.numel() for m in self.master)
        return n * 4 * (1 if self.device_nvme else 3)

    def _hyper(self):
        opt = self.optimizer
        return dict(beta1=opt.betas[0], beta2=opt.betas[1], eps=opt.eps,
                    weight_decay=opt.weight_decay, adamw_mode=opt.adam_w_mode,
                    bias_correction=opt.bias_correction)

    def _moments(self, i, n):
        """(exp_avg, exp_avg_sq) of leaf i, prefetching leaf i + 1's from
        NVMe."""
        if self.swapper is None:
            return self.m[i], self.v[i]
        m, v = self.swapper.fetch(i)
        if i + 1 < n:
            self.swapper.prefetch(i + 1)
        return m, v

    # -- the step -----------------------------------------------------------
    def _staging(self, grads, out_dtype):
        """The ring of (gradient, output) staging slots, page-locked on
        CUDA, each of the largest leaf's size."""
        most = max(g.numel() for g in grads)
        key = (most, grads[0].dtype, out_dtype)
        if self._slots is None or self._slots[0] != key:
            pin = self.cuda
            self._slots = (key, [
                (torch.empty(most, dtype=grads[0].dtype, pin_memory=pin),
                 torch.empty(most, dtype=out_dtype, pin_memory=pin))
                for _ in range(SLOTS)])
            if self.cuda and not all(a.is_pinned() and b.is_pinned()
                                     for a, b in self._slots[1]):
                raise RuntimeError("host offload staging is not pinned")
        return self._slots[1]

    def step_streamed(self, grads, lr, grad_scale=1.0, params=None,
                      park=None):
        """One step from ``grads`` (device or host tensors, fp32 or bf16;
        fp16 is widened) with ``grad_scale`` folded into the read. The
        updated leaves go to ``params`` (the compute copy on the card, in
        its dtype: fp32, bf16 or fp16; a leaf may be a strided view, a
        rank's slice on a dim other than 0) or, with ``park(i,
        host_tensor)``, to the caller (the NVMe parameter tier's
        write-behind)."""
        self.step_count += 1
        h = self._hyper()
        n = len(self.master)
        grads = [g.detach() if g.dtype != torch.float16 else g.detach().float()
                 for g in grads]
        out_dtype = params[0].dtype if params is not None else torch.bfloat16
        if out_dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"compute dtype {out_dtype}: the host runner "
                             f"writes fp32, bf16 or fp16 parameters")
        on_card = self.cuda and grads[0].is_cuda
        slots = self._staging(grads, out_dtype)
        if on_card:
            cur = torch.cuda.current_stream(self.device)
            d2h = torch.cuda.Stream(self.device)
            h2d = torch.cuda.Stream(self.device)
            d2h.wait_stream(cur)
            landed = [torch.cuda.Event() for _ in range(n)]
            freed = [torch.cuda.Event() for _ in range(SLOTS)]

        def fetch(i):
            s = i % SLOTS
            g = grads[i].reshape(-1)
            buf = slots[s][0][:g.numel()]
            if on_card:
                with torch.cuda.stream(d2h):
                    if i >= SLOTS:
                        d2h.wait_event(freed[s])
                    buf.copy_(g, non_blocking=True)
                    landed[i].record(d2h)
            else:
                buf.copy_(g)

        for i in range(min(SLOTS, n)):
            fetch(i)
        if self.swapper is not None and n:
            self.swapper.prefetch(0)
        adam_s = 0.0
        for i in range(n):
            s = i % SLOTS
            g = slots[s][0][:grads[i].numel()]
            out = slots[s][1][:grads[i].numel()]
            if on_card:
                landed[i].synchronize()
            m, v = self._moments(i, n)
            t0 = time.perf_counter()
            p = self.master[i].view(-1)
            self.native.adam_step_ex(
                p, g, m.view(-1), v.view(-1), self.step_count, lr,
                h["beta1"], h["beta2"], h["eps"], h["weight_decay"],
                h["adamw_mode"], h["bias_correction"], grad_scale=grad_scale,
                params_bf16=out if out_dtype == torch.bfloat16 else None)
            adam_s += time.perf_counter() - t0
            if out_dtype != torch.bfloat16:
                out.copy_(p)
            if self.swapper is not None:
                self.swapper.store(i, m, v)
            if park is not None:
                park(i, out.view(self.shapes[i]))
            elif on_card:
                with torch.cuda.stream(h2d):
                    params[i].copy_(out.view(self.shapes[i]),
                                    non_blocking=True)
                    freed[s].record(h2d)
            else:
                params[i].copy_(out.view(self.shapes[i]))
            if i + SLOTS < n:
                fetch(i + SLOTS)
        if on_card:
            cur.wait_stream(h2d)
        self.last_adam_s = adam_s

    # -- checkpoints -------------------------------------------------------
    def master_leaves(self):
        return [m.clone() for m in self.master]

    def load_master_leaves(self, masters):
        with torch.no_grad():
            for mine, m in zip(self.master, masters):
                mine.copy_(m)

    def state_dict(self):
        if self.swapper is not None:
            moments = [[t.clone() for t in self.swapper.fetch(i)]
                       for i in range(len(self.master))]
            m = [a for a, _ in moments]
            v = [b for _, b in moments]
        else:
            m, v = self.m, self.v
        return {"step": self.step_count,
                "exp_avg": [t.clone() for t in m],
                "exp_avg_sq": [t.clone() for t in v]}

    def load_state_dict(self, sd):
        self.step_count = int(sd["step"])
        for i in range(len(self.master)):
            mi = sd["exp_avg"][i].detach().to("cpu", torch.float32,
                                              copy=True).contiguous()
            vi = sd["exp_avg_sq"][i].detach().to("cpu", torch.float32,
                                                 copy=True).contiguous()
            if self.swapper is not None:
                self.swapper.store(i, mi, vi)
            else:
                self.m[i], self.v[i] = mi, vi

    def close(self):
        if self.swapper is not None:
            self.swapper.release()
            self.swapper = None
        self.master = self.m = self.v = None
        self._slots = None
