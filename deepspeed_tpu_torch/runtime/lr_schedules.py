"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR.

Port of ``deepspeed_tpu/runtime/lr_schedules.py``. Each schedule is a
function ``step -> lr`` built from fp32 torch ops, so the engine evaluates
it on the device from the device step counter (the JAX engine evaluates
it inside the jitted step): no host read per step. A torch-style
``step()/get_lr()`` shell on a host counter sits on top.
"""

import math

import torch

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


class _Schedule:
    """Callable schedule with a torch-LR-scheduler-compatible shell."""

    def __init__(self, optimizer=None, last_batch_iteration=-1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step):
        raise NotImplementedError

    def __call__(self, step):
        return self.lr_at(step)

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        return [float(self.lr_at(max(self.last_batch_iteration, 0)))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class LRRangeTest(_Schedule):
    """lr = min_lr * (1 + step/step_size * step_rate), continuous or
    staircase."""

    def __init__(self, optimizer=None, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def lr_at(self, step):
        step = _f32(step)
        x = torch.floor(step / self.step_size) if self.staircase \
            else step / self.step_size
        return self.min_lr * (1.0 + x * self.step_rate)


class OneCycle(_Schedule):
    """1-cycle: min→max over the first step size, max→min over the
    second, then exponential decay by decay_lr_rate. The momentum and
    stair-count arguments are accepted for config parity; no optimizer
    of the port reads a momentum schedule."""

    def __init__(self, optimizer=None, cycle_min_lr=1e-3, cycle_max_lr=1e-2,
                 decay_lr_rate=0.0, cycle_first_step_size=2000,
                 cycle_second_step_size=None, cycle_first_stair_count=0,
                 cycle_second_stair_count=None, decay_step_size=0,
                 cycle_momentum=True, cycle_min_mom=0.8, cycle_max_mom=0.9,
                 decay_mom_rate=0.0, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first = float(cycle_first_step_size)
        self.second = float(cycle_second_step_size
                            if cycle_second_step_size is not None
                            else cycle_first_step_size)
        self.decay_step_size = max(float(decay_step_size), 1.0)

    def lr_at(self, step):
        step = _f32(step)
        total = self.first + self.second
        up = self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * (
            step / self.first)
        down = self.cycle_max_lr - (self.cycle_max_lr - self.cycle_min_lr) * (
            (step - self.first) / self.second)
        post = step - total
        if self.decay_lr_rate > 0:
            decayed = self.cycle_min_lr * torch.pow(
                torch.tensor(1.0 / (1.0 + self.decay_lr_rate),
                             device=step.device), post / self.decay_step_size)
        else:
            decayed = torch.full_like(step, self.cycle_min_lr)
        lr = torch.where(step <= self.first, up,
                         torch.where(step <= total, down, decayed))
        return torch.clamp(lr, min=0.0)


class WarmupLR(_Schedule):
    """min→max over warmup_num_steps, then constant; warmup_type "log"
    ramps by log(step+1)/log(num_steps+1)."""

    def __init__(self, optimizer=None, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type="log",
                 last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(warmup_num_steps, 2)
        self.warmup_type = warmup_type

    def _ramp(self, step):
        if self.warmup_type == "log":
            return torch.log1p(torch.clamp(step, max=self.warmup_num_steps)) \
                / torch.tensor(math.log(self.warmup_num_steps + 1),
                               dtype=torch.float32)
        return torch.clamp(step / self.warmup_num_steps, 0.0, 1.0)

    def lr_at(self, step):
        step = _f32(step)
        return self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) \
            * self._ramp(step)


class WarmupDecayLR(WarmupLR):
    """Warmup, then linear decay to 0 at total_num_steps."""

    def __init__(self, optimizer=None, total_num_steps=10000, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000, warmup_type="log",
                 last_batch_iteration=-1):
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr,
                         warmup_num_steps, warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps

    def lr_at(self, step):
        step = _f32(step)
        warm = super().lr_at(step)
        decay = torch.clamp(
            (self.total_num_steps - step)
            / max(float(self.total_num_steps - self.warmup_num_steps), 1.0),
            0.0, 1.0)
        return torch.where(step < self.warmup_num_steps, warm,
                           self.warmup_max_lr * decay)


SCHEDULES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_lr_schedule(name, params, optimizer=None):
    if name not in SCHEDULES:
        raise ValueError(f"unknown LR schedule {name}; valid: "
                         f"{VALID_LR_SCHEDULES}")
    return SCHEDULES[name](optimizer=optimizer, **params)
