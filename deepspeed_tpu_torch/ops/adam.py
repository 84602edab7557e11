"""Adam/AdamW for the port's engine.

Port of ``deepspeed_tpu/ops/adam.py`` (``FusedAdam`` :22, ``Adam``
:115): fp32 math whatever the storage, ``exp_avg`` stored in
``moment_dtype`` ("fp32" or "bf16"), ``exp_avg_sq`` always fp32, bias
correction with ``count = step + 1``, and the engine's loss-scale inverse
times clip coefficient folded into one ``grad_scale`` read. The update
runs as ``torch._foreach_*`` ops over groups of leaves;
``torch.optim.AdamW`` is not used, as its bf16 moment rounding and its
decay order differ from the reference.
"""

import dataclasses
from typing import Tuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer, tensors_like


@dataclasses.dataclass
class FusedAdam(TorchOptimizer):
    """Adam/AdamW; ``adam_w_mode=True`` is AdamW (decoupled decay)."""
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True
    amsgrad: bool = False
    moment_dtype: str = "fp32"

    param_like_state_fields = ("exp_avg", "exp_avg_sq")

    def __post_init__(self):
        if self.amsgrad:
            raise ValueError("FusedAdam does not support the AMSGrad variant "
                             "(parity with reference fused_adam.py:40)")
        if self.moment_dtype not in ("fp32", "bf16"):
            raise ValueError(f"moment_dtype must be 'fp32' or 'bf16', got "
                             f"{self.moment_dtype!r}")

    def init(self, params):
        device = params[0].device if params else "cpu"
        mdt = torch.bfloat16 if self.moment_dtype == "bf16" else torch.float32
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "exp_avg": tensors_like(params, mdt),
                "exp_avg_sq": tensors_like(params, torch.float32)}

    def step(self, params, grads, state, lr=None, grad_scale=None,
             finite=None):
        """Update fp32 ``params`` and ``state`` in place from ``grads``
        (any float dtype; an fp32 gradient list is used as scratch).
        ``lr`` and ``grad_scale`` may be device tensors. ``finite`` (a
        bool device tensor, or None) False makes the step a no-op that
        leaves params and state bit for bit as they were: the gradients
        are zeroed, the betas and lr become 1 and 0, and the step count
        stays. The leaves are updated in groups of at most
        ``GROUP_ELEMENTS`` elements (a larger leaf alone), so the fp32
        temporaries stay a group's size; every operation is elementwise,
        so the grouping changes no bit."""
        lr = self.lr if lr is None else lr
        beta1, beta2 = self.betas
        count = state["step"] + 1
        bc1 = bc2 = None
        if self.bias_correction:
            cf = count.float()
            bc1 = 1.0 - torch.pow(beta1, cf)
            bc2 = 1.0 - torch.pow(beta2, cf)
        if finite is not None:
            keep = finite.float()
            beta1_t = torch.where(finite, beta1, 1.0)
            beta2_t = torch.where(finite, beta2, 1.0)
            lr = lr * keep
        else:
            keep, beta1_t, beta2_t = None, beta1, beta2
        for idx in _groups(params):
            self._step_group([params[i] for i in idx],
                             [grads[i] for i in idx],
                             [state["exp_avg"][i] for i in idx],
                             [state["exp_avg_sq"][i] for i in idx],
                             lr, grad_scale, keep, beta1_t, beta2_t, bc1,
                             bc2)
        state["step"] = count if finite is None else torch.where(
            finite, count, state["step"])

    def _step_group(self, params, grads, exp_avg, v, lr, grad_scale, keep,
                    beta1_t, beta2_t, bc1, bc2):
        beta1, beta2 = self.betas
        g = [x.float() for x in grads]
        if grad_scale is not None:
            torch._foreach_mul_(g, grad_scale)
        if self.weight_decay != 0.0 and not self.adam_w_mode:
            torch._foreach_add_(g, params, alpha=self.weight_decay)
        if keep is not None:
            for x in g:
                x.nan_to_num_(0.0, 0.0, 0.0)
            torch._foreach_mul_(g, keep)
        m = [x.float() for x in exp_avg]
        torch._foreach_mul_(m, beta1_t)
        torch._foreach_add_(m, g, alpha=1.0 - beta1)
        torch._foreach_mul_(v, beta2_t)
        torch._foreach_addcmul_(v, g, g, value=1.0 - beta2)
        del g
        if self.bias_correction:
            denom = torch._foreach_div(v, bc2)
            update = torch._foreach_div(m, bc1)
        else:
            denom = [t.clone() for t in v]
            update = [t.clone() for t in m]
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        del denom
        if self.weight_decay != 0.0 and self.adam_w_mode:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(params, update)
        if self.moment_dtype == "bf16":
            torch._foreach_copy_(exp_avg, m)


# the most elements a group of leaves updates at once: its fp32 scratch
# (the gradients, the first moment, the denominator and the update) is 4
# x 4 bytes an element, 2 GiB at this size, where all the leaves of a
# 3.5B-parameter model at once would take 56 GB
GROUP_ELEMENTS = 1 << 27


def _groups(params):
    """Consecutive index groups of ``params`` of at most GROUP_ELEMENTS
    elements each (a larger leaf alone)."""
    out, cur, n = [], [], 0
    for i, p in enumerate(params):
        if cur and n + p.numel() > GROUP_ELEMENTS:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += p.numel()
    if cur:
        out.append(cur)
    return out


@dataclasses.dataclass
class Adam(FusedAdam):
    """Plain Adam (L2 decay)."""
    adam_w_mode: bool = False


@dataclasses.dataclass
class DeepSpeedCPUAdam(FusedAdam):
    """Host-resident Adam for ZeRO-Offload (``deepspeed_tpu/ops/adam.py:
    120``): the optimizer type ``cpuadam``. It loads the native SIMD
    library (``csrc/cpu_adam.cpp``) when made, and raises when that
    cannot be built (the JAX class falls back to numpy). The offload
    runners step it on the host; without offload the engine runs it as
    ``FusedAdam``, as the JAX engine does."""

    def __post_init__(self):
        super().__post_init__()
        from deepspeed_tpu_torch.ops.native import cpu_adam
        cpu_adam.load()
