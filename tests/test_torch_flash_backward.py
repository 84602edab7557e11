"""deepspeed_tpu_torch flash-attention backward vs the JAX Pallas kernels.

The plain backward (what a CPU tensor runs), reached through
``FlashAttentionFunction``, is held against ``jax.vjp`` of the Pallas
``flash_attention`` in interpret mode at fp32, through both JAX routes:
the whole-row ``_flash_bwd`` and the chunked ``_flash_bwd_chunked``
(forced with ``chunk=``). The CUDA kernels are held against the plain
versions on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.attention import FlashAttentionFunction
from deepspeed_tpu_torch.ops.cuda import builder, tolerance
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain, flash_attention_bwd_plain,
    flash_attention_fwd_plain)
from torch_port_common import assert_close, cuda_device, t32  # noqa: F401


def _jax():
    """(jax, the Pallas flash module), imported here so the gpu tests run
    where JAX is not installed."""
    return (importlib.import_module("jax"),
            importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention"))


def _inputs(S, H, Hkv, D=32, B=2, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, S, D).astype(np.float32),
            rs.randn(B, Hkv, S, D).astype(np.float32),
            rs.randn(B, Hkv, S, D).astype(np.float32),
            rs.randn(B, H, S, D).astype(np.float32))


# (S, causal, H, Hkv, chunk): chunk=None is _flash_bwd, else the chunked
# kernels (S // chunk chunks of 64-row blocks)
CASES = [(64, True, 4, 4, None), (128, False, 4, 2, None),
         (128, True, 4, 1, None), (128, True, 4, 4, 64),
         (256, False, 2, 2, 128), (128, True, 4, 2, 64)]


@pytest.mark.parametrize("S,causal,H,Hkv,chunk", CASES)
def test_plain_flash_backward_matches_pallas(S, causal, H, Hkv, chunk):
    jax, jfa = _jax()
    q, k, v, do = _inputs(S, H, Hkv)

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal, interpret=True,
                                   block_q=64, block_k=64, chunk=chunk)
    o_j, vjp = jax.vjp(f, q, k, v)
    dq_j, dk_j, dv_j = vjp(do)

    qt, kt, vt = (t32(a).requires_grad_() for a in (q, k, v))
    o = FlashAttentionFunction.apply(qt, kt, vt, causal, None)
    dq, dk, dv = torch.autograd.grad(o, (qt, kt, vt), t32(do))
    assert_close(o, np.asarray(o_j))
    assert_close(dq, np.asarray(dq_j))
    assert_close(dk, np.asarray(dk_j))
    assert_close(dv, np.asarray(dv_j))


def test_plain_backward_matches_autograd_of_reference():
    """The recompute backward equals autograd through the plain forward
    (an independent check of delta, the mask and the GQA sum)."""
    q, k, v, do = (t32(a) for a in _inputs(48, 4, 2, D=16))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o_ref = flash_attention_fwd_plain(qr, kr, vr, causal=True)[0]
    want = torch.autograd.grad(o_ref, (qr, kr, vr), do)
    o, lse = flash_attention_fwd_plain(q, k, v, causal=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_kernel_check_admits_rounding_and_rejects_a_dropped_tile():
    """The limits the CUDA kernels are held to on the card admit dk/dv/dq
    rounded at other points (fp32 math rounded once to bf16 at the end)
    and reject the planted faults chip_smoke.py uses: one q tile's
    contribution dropped from dk/dv, one k tile dropped from dq."""
    q, k, v, do = (t32(a).to(torch.bfloat16)
                   for a in _inputs(256, 4, 4, D=64, B=1))
    o, lse = flash_attention_fwd_plain(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, True)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, True)
    f32 = [t.float() for t in (q, k, v, do)]
    dk32, dv32 = flash_attention_bwd_dkv_plain(*f32, lse, delta, True)
    dq32 = flash_attention_bwd_dq_plain(*f32, lse, delta, True)
    tolerance.check_kernel("flash_attention_bwd_dkv", dk32.bfloat16(), dk)
    tolerance.check_kernel("flash_attention_bwd_dkv", dv32.bfloat16(), dv)
    tolerance.check_kernel("flash_attention_bwd_dq", dq32.bfloat16(), dq)
    qf, dof = q.clone(), do.clone()
    qf[:, :, -64:] = 0
    dof[:, :, -64:] = 0
    dk_f, dv_f = flash_attention_bwd_dkv_plain(qf, k, v, dof, lse, delta,
                                               True)
    for got, want in ((dk_f, dk), (dv_f, dv)):
        with pytest.raises(AssertionError, match="row-relative error"):
            tolerance.check_kernel("flash_attention_bwd_dkv", got, want)
    kf = k.clone()
    kf[:, :, :64] = 0
    dq_f = flash_attention_bwd_dq_plain(q, kf, v, do, lse, delta, True)
    with pytest.raises(AssertionError, match="row-relative error"):
        tolerance.check_kernel("flash_attention_bwd_dq", dq_f, dq)


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,causal", [(1024, 20, True), (200, 8, False),
                                        (8192, 2, True), (16, 4, True)])
def test_cuda_flash_backward_matches_plain(cuda_device, S, H, causal):
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _inputs(S, H, H, D=64, B=1))
    o, lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    n_dkv = builder.launches["flash_attention_bwd_dkv"]
    n_dq = builder.launches["flash_attention_bwd_dq"]
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert builder.launches["flash_attention_bwd_dkv"] == n_dkv + 1
    assert builder.launches["flash_attention_bwd_dq"] == n_dq + 1
    dk_p, dv_p = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               causal)
    tolerance.check_kernel("flash_attention_bwd_dkv", dk, dk_p)
    tolerance.check_kernel("flash_attention_bwd_dkv", dv, dv_p)
    tolerance.check_kernel("flash_attention_bwd_dq", dq,
                           flash_attention_bwd_dq_plain(q, k, v, do, lse,
                                                        delta, causal))
    # planted faults the same checks must reject: the last 16-query rows'
    # contribution dropped from dk, the first 16 keys dropped from dq
    qf, dof, kf = q.clone(), do.clone(), k.clone()
    qf[:, :, -16:] = 0
    dof[:, :, -16:] = 0
    kf[:, :, :16] = 0
    with pytest.raises(AssertionError, match="row-relative error"):
        tolerance.check_kernel("flash_attention_bwd_dkv", dk,
                               flash_attention_bwd_dkv_plain(
                                   qf, k, v, dof, lse, delta, causal)[0])
    with pytest.raises(AssertionError, match="row-relative error"):
        tolerance.check_kernel("flash_attention_bwd_dq", dq,
                               flash_attention_bwd_dq_plain(
                                   q, kf, v, do, lse, delta, causal))


@pytest.mark.gpu
def test_cuda_function_gqa_matches_plain(cuda_device):
    """FlashAttentionFunction on the card (forward kernel, both backward
    kernels, the GQA repeat and sum) against the plain backward."""
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _inputs(320, 8, 2, D=64, B=2))
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    o = FlashAttentionFunction.apply(qt, kt, vt, True, None)
    got = torch.autograd.grad(o, (qt, kt, vt), do)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=True)
    want = flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        tolerance.check_kernel("flash_attention_bwd_dq" if name == "dq"
                               else "flash_attention_bwd_dkv", g, w)


@pytest.mark.gpu
def test_cuda_flash_backward_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 16, 64, device=cuda_device)
    lse = torch.zeros(1, 2, 16, device=cuda_device)
    with pytest.raises(NotImplementedError):
        flash_attention_bwd_dq(q, q, q, q, lse, lse)          # fp32
    qb = torch.zeros(1, 2, 16, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        flash_attention_bwd_dkv(qb, qb, qb, qb, lse, lse)     # head dim 32


@pytest.mark.gpu
def test_cuda_train_batch_runs_through_the_kernels(cuda_device):
    """initialize + train_batch on the card: a 2-layer GPT-2 of head dim
    64 launches the forward and both backward kernels once per layer and
    step, and its loss falls."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_tiny
    cfg = gpt2_tiny(n_embd=128, n_head=2, loss_chunk=64)
    engine, _, _, _ = dst.initialize(
        model=GPT2LMHeadModel(cfg), device=cuda_device,
        config={"train_batch_size": 4, "bf16": {"enabled": True},
                "data_types": {"grad_dtype": "bf16"},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 128))).to(cuda_device)
    builder.launches.clear()
    losses = [float(engine.train_batch({"input_ids": ids}))
              for _ in range(4)]
    assert losses[-1] < losses[0]
    assert {k: builder.launches[k] for k in (
        "flash_attention_fwd", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq")} == {
        "flash_attention_fwd": 8, "flash_attention_bwd_dkv": 8,
        "flash_attention_bwd_dq": 8}
