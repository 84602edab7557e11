"""Optimizer protocol for the port's engine.

Port of ``deepspeed_tpu/ops/optimizer.py``. The JAX optimizers are pure
functions over pytrees; the port's update the engine's fp32 master
tensors in place (no second copy of the state at 774M parameters):

    state = opt.init(params)                  # params: list of tensors
    opt.step(params, grads, state, lr, grad_scale=None, finite=None)

State entries mirror ``params`` leaf for leaf (``exp_avg`` etc.), and the
counters are device tensors, so a step reads nothing back to the host.
``finite`` (a bool device tensor) False makes the step leave params and
state as they were: the engine's skip on an fp16 overflow.
"""

import torch


class TorchOptimizer:
    """Base class: subclasses implement ``init`` and an in-place
    ``step``."""

    #: state fields with one tensor per parameter (the checkpoint maps
    #: them through the model's bridge like the parameters)
    param_like_state_fields = ()
    #: whether the update of an element reads that element's gradient and
    #: state alone, so a rank may step a slice of a leaf (ZeRO stages 1-2
    #: at world size n); a per-tensor statistic (LAMB's trust ratio) is not
    elementwise_update = False

    def init(self, params):
        raise NotImplementedError

    def step(self, params, grads, state, lr, grad_scale=None, finite=None):
        raise NotImplementedError


def tensors_like(params, dtype=None):
    return [torch.zeros_like(p, dtype=dtype or p.dtype) for p in params]
