"""Step time of GPT-2 large training with and without MoQ and progressive
layer drop, on one NVIDIA GPU.

    python3 tests/perf/torch_moq_steps.py

chip_smoke.py's training model and config (bf16 compute, fp32 masters,
batch 8 x 1024) in four variants: plain, PLD alone (theta 0.5, gamma
0.001), MoQ with asymmetric stochastic rounding and the blend (the
``train_moq_sr`` block) without PLD, and with it. Each runs 2 warm-up and
5 timed ``train_batch`` steps between synchronizes (one JSON line each:
``step_ms``); the two PLD variants then run three steps under
torch.profiler (chip_smoke's ``train_profile_phase``: device time by
kernel group, the device's idle share). Needs one NVIDIA GPU.
"""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import chip_smoke as c  # noqa: E402


def main():
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    c.phase_device()
    moq_sr = c.moq_sr_ds_config()
    variants = {
        "plain": c.train_ds_config(),
        "pld": dict(c.train_ds_config(),
                    progressive_layer_drop=dict(c.PLD)),
        "moq_sr_no_pld": {k: v for k, v in moq_sr.items()
                          if k != "progressive_layer_drop"},
        "moq_sr_pld": moq_sr,
    }
    for name, cfg in variants.items():
        engine, _, _, _ = ds.initialize(
            config=cfg, model=GPT2LMHeadModel(c.train_model_config()))
        batch = c.train_batch_ids()
        for _ in range(2):
            engine.train_batch(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            engine.train_batch(batch)
        torch.cuda.synchronize()
        print(json.dumps({"variant": name, "step_ms":
                          (time.perf_counter() - t0) / 5 * 1e3}), flush=True)
        if name in ("pld", "moq_sr_pld"):
            c.train_profile_phase(engine, batch, phase=name + "_profile")
        del engine, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
