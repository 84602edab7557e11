"""Device resolution for the port's entry points.

The port's counterpart of ``deepspeed_tpu/utils/platform.py``: where the
JAX package asks which backend it landed on, the port is told. Entry
points run on the card unless the caller asks for the CPU, and they
never move to the CPU on their own.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``. Raises when CUDA is asked for and absent,
    naming the way out (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev
