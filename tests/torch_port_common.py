"""Shared pieces of the deepspeed_tpu_torch parity tests."""

import numpy as np
import pytest
import torch

# plain version vs the JAX function, both fp32 on the CPU (a kernel is
# held against its plain version by deepspeed_tpu_torch.ops.cuda.tolerance)
FP32_ATOL, FP32_RTOL = 2e-5, 2e-5


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode. Tests
    using this fixture carry the ``gpu`` marker; run them on a machine
    with a card with ``python -m pytest -m gpu tests/test_torch_*.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def t32(a):
    """numpy → fp32 CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def assert_close(got, want, atol=FP32_ATOL, rtol=FP32_RTOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().float().cpu() if torch.is_tensor(got)
                   else got, np.float32),
        np.asarray(want.detach().float().cpu() if torch.is_tensor(want)
                   else want, np.float32),
        atol=atol, rtol=rtol)
