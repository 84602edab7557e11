"""Mixed precision: bf16, and fp16 with the dynamic loss scaler.

Port of ``deepspeed_tpu/runtime/precision.py``. The scaler state is a
dict of device tensors updated without a host read: the scale doubles
every ``loss_scale_window`` overflow-free steps and halves on overflow
after ``hysteresis`` grace, clamped at ``min_loss_scale``; an overflowed
step is skipped by the engine.
"""

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    fp16: bool = False               # fp16 mode (dynamic loss scale)
    static_loss_scale: float = 0     # >0 → static scale
    initial_scale_power: int = 32
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0

    @staticmethod
    def from_ds_config(cfg):
        """bf16 needs no loss scale; the model's config holds the compute
        dtype, as in the JAX engine."""
        if cfg.fp16_enabled:
            return PrecisionConfig(fp16=True,
                                   static_loss_scale=cfg.loss_scale,
                                   initial_scale_power=cfg.initial_scale_power,
                                   loss_scale_window=cfg.loss_scale_window,
                                   hysteresis=cfg.hysteresis,
                                   min_loss_scale=cfg.min_loss_scale)
        return PrecisionConfig()

    @property
    def dynamic(self):
        return self.fp16 and not self.static_loss_scale


def init_scaler_state(cfg: PrecisionConfig, device=None) -> Dict[str, Any]:
    if cfg.static_loss_scale:
        scale = float(cfg.static_loss_scale)
    elif cfg.fp16:
        scale = float(2.0 ** cfg.initial_scale_power)
    else:
        scale = 1.0

    def t(value, dtype):
        return torch.tensor(value, dtype=dtype, device=device)
    return {"loss_scale": t(scale, torch.float32),
            "good_steps": t(0, torch.int32),
            "hysteresis": t(cfg.hysteresis, torch.int32),
            "overflow": t(False, torch.bool),
            "skipped_steps": t(0, torch.int32)}


def grads_finite(grads) -> torch.Tensor:
    """One device bool: every gradient entry is finite."""
    if not grads:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def update_scaler(state, cfg: PrecisionConfig, finite: torch.Tensor):
    """One scaler transition; static mode only records the overflow
    bit."""
    over = ~finite
    skipped = state["skipped_steps"] + over.int()
    if not cfg.dynamic:
        return {**state, "overflow": over, "skipped_steps": skipped}
    scale = state["loss_scale"]
    good = state["good_steps"]
    hyst = state["hysteresis"]
    new_hyst = torch.clamp(hyst - 1, min=1)
    drop_scale = torch.clamp(scale / 2.0, min=cfg.min_loss_scale)
    o_scale = torch.where(hyst <= 1, drop_scale, scale)
    grow = (good + 1) >= cfg.loss_scale_window
    c_scale = torch.where(grow, scale * 2.0, scale)
    c_good = torch.where(grow, torch.zeros_like(good), good + 1)
    return {"loss_scale": torch.where(finite, c_scale, o_scale),
            "good_steps": torch.where(finite, c_good, torch.zeros_like(good)),
            "hysteresis": torch.where(finite, torch.full_like(
                hyst, cfg.hysteresis), new_hyst),
            "overflow": over, "skipped_steps": skipped}
