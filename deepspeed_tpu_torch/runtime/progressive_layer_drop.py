"""Progressive Layer Drop: port of
``deepspeed_tpu/runtime/progressive_layer_drop.py``.

theta(t) = (1 - theta_base) * exp(-gamma * t) + theta_base, the keep
probability the engine feeds the model at step t (its blocks compute
x + keep * sublayer(x)). ``theta_at`` of a device step counter is a
device fp32 scalar, so a step reads nothing back.
"""

import torch


class ProgressiveLayerDrop:
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma

    def theta_at(self, step):
        step = torch.as_tensor(step).to(torch.float32)
        return (1.0 - self.theta) * torch.exp(-self.gamma * step) + self.theta
