"""deepspeed_tpu_torch flash-attention forward vs the JAX Pallas kernel.

The plain version (what a CPU tensor runs) is held against
``deepspeed_tpu.ops.pallas.flash_attention`` in interpret mode at fp32;
the CUDA kernel is held against the plain version on the card.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.attention import (dot_product_attention,
                                               reference_attention)
from deepspeed_tpu_torch.ops.cuda import builder, tolerance
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)
from torch_port_common import assert_close, cuda_device, t32  # noqa: F401


def _jax():
    """(jax.numpy, the Pallas flash module), imported here and not at
    the top so the gpu tests also run where JAX is not installed (the
    package re-exports the function under the module's name)."""
    return (importlib.import_module("jax.numpy"),
            importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention"))


# (S, D, causal, H, Hkv)
CASES = [(16, 32, True, 4, 4), (64, 64, False, 4, 4), (128, 64, True, 4, 2),
         (128, 32, False, 4, 1), (64, 32, True, 2, 2), (16, 64, False, 4, 2)]


def _inputs(S, D, H, Hkv, B=2, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, S, D).astype(np.float32)
    k = rs.randn(B, Hkv, S, D).astype(np.float32)
    v = rs.randn(B, Hkv, S, D).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S,D,causal,H,Hkv", CASES)
def test_plain_flash_matches_pallas(S, D, causal, H, Hkv):
    jnp, jfa = _jax()
    q, k, v = _inputs(S, D, H, Hkv)
    B = q.shape[0]
    scale = 1.0 / math.sqrt(D)
    block = min(64, S)
    o_j, lse_j = jfa._flash_fwd(
        jnp.asarray(q.reshape(B * H, S, D)),
        jnp.asarray(k.reshape(B * Hkv, S, D)),
        jnp.asarray(v.reshape(B * Hkv, S, D)), scale, causal, block, block,
        True, heads=H, kv_heads=Hkv)
    o, lse = flash_attention_fwd(t32(q), t32(k), t32(v), causal=causal)
    assert_close(o, np.asarray(o_j).reshape(B, H, S, D))
    assert_close(lse, np.asarray(lse_j).reshape(B, H, S))
    # the public op: JAX flash_attention vs the port's CPU dispatch
    o_pub = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    assert_close(dot_product_attention(t32(q), t32(k), t32(v),
                                       causal=causal), np.asarray(o_pub))


def test_reference_attention_bias_and_segments():
    """reference_attention's bias and segment-id masks against the JAX
    reference (the CUDA path takes neither)."""
    from deepspeed_tpu.ops.attention import reference_attention as jref
    jnp, _ = _jax()
    q, k, v = _inputs(16, 32, 4, 2)
    rs = np.random.RandomState(1)
    bias = rs.randn(2, 1, 16, 16).astype(np.float32)
    seg = np.repeat(np.array([[0] * 8 + [1] * 8]), 2, 0).astype(np.int32)
    want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                bias=jnp.asarray(bias), segment_ids=jnp.asarray(seg))
    got = reference_attention(t32(q), t32(k), t32(v), causal=True,
                              bias=t32(bias), segment_ids=torch.from_numpy(seg))
    assert_close(got, np.asarray(want))


def test_kernel_check_admits_rounding_and_rejects_a_dropped_tile():
    """The limit the CUDA kernel is held to on the card admits o rounded
    at other points and rejects o missing the last 16-key tile of 256;
    lse (fp32 on both sides) is held to an absolute limit."""
    q, k, v = (t32(a).to(torch.bfloat16) for a in _inputs(256, 64, 4, 2))
    o, lse = flash_attention_fwd_plain(q, k, v)
    o32, lse32 = flash_attention_fwd_plain(q.float(), k.float(), v.float())
    assert tolerance.check_kernel("flash_attention_fwd",
                                  o32.to(torch.bfloat16), o) > 0
    tolerance.check_lse(lse32, lse)
    o_f, lse_f = flash_attention_fwd_plain(q, k[:, :, :-16], v[:, :, :-16])
    with pytest.raises(AssertionError, match="row-relative error"):
        tolerance.check_kernel("flash_attention_fwd", o_f, o)
    with pytest.raises(AssertionError, match="lse error"):
        tolerance.check_lse(lse_f, lse)


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,Hkv,causal", [(16, 20, 20, True),
                                             (1024, 20, 20, True),
                                             (200, 8, 2, False),
                                             (8192, 4, 4, True)])
def test_cuda_flash_matches_plain(cuda_device, S, H, Hkv, causal):
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _inputs(S, 64, H, Hkv, B=1))
    n0 = builder.launches["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert builder.launches["flash_attention_fwd"] == n0 + 1
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=causal)
    tolerance.check_kernel("flash_attention_fwd", o, o_ref)
    tolerance.check_lse(lse, lse_ref)


@pytest.mark.gpu
def test_cuda_flash_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 16, 64, device=cuda_device)
    with pytest.raises(NotImplementedError):
        flash_attention_fwd(q, q, q)                  # fp32 on CUDA
    qb = torch.zeros(1, 2, 16, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        flash_attention_fwd(qb, qb, qb)               # head dim 32
