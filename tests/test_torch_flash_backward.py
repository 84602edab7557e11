"""deepspeed_tpu_torch flash-attention backward vs the JAX Pallas kernels.

The plain backward (what a CPU tensor runs), reached through
``FlashAttentionFunction``, is held against ``jax.vjp`` of the Pallas
``flash_attention`` in interpret mode at fp32, through both JAX routes:
the whole-row ``_flash_bwd`` and the chunked ``_flash_bwd_chunked``
(forced with ``chunk=``). The tile-by-tile emulation of the CUDA kernel
(its order: key tiles ascending, the first dq part stored, fp32 adds, the
last contributor's cast) is held against both JAX routes called directly
and against the plain backward; the kernel's launch mirrors (walk,
blocks, the dQ writer's ordered waits, shared memory) are checked here
too. The CUDA kernels are held against the plain versions on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.attention import FlashAttentionFunction
from deepspeed_tpu_torch.ops.cuda import builder, tolerance
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_delta,
    flash_attention_bwd_delta_plain, flash_attention_bwd_kernel,
    flash_attention_bwd_kernel_plain, flash_attention_bwd_plain,
    flash_attention_bwd_tiles, flash_attention_fwd_plain)
from torch_port_common import assert_close, cuda_device, t32  # noqa: F401

# the H100's shared memory a block can use
SMEM_LIMIT = 232448


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
    """The limits the CUDA kernels are held to on the card admit dq, dk,
    dv rounded at other points (fp32 math rounded once to bf16 at the end)
    and reject the planted faults chip_smoke.py uses: the last q tile's
    contribution dropped from dk/dv, the first key tile dropped from dq,
    one position's delta dropped."""
    q, k, v, do = (t32(a).to(torch.bfloat16)
                   for a in _inputs(256, 4, 4, D=64, B=1))
    o, lse = flash_attention_fwd_plain(q, k, v, causal=True)
    delta = flash_attention_bwd_delta_plain(o, do)
    dq, dk, dv = flash_attention_bwd_kernel_plain(q, k, v, do, lse, delta,
                                                  True)
    f32 = [t.float() for t in (q, k, v, do)]
    dq32, dk32, dv32 = flash_attention_bwd_kernel_plain(*f32, lse, delta,
                                                        True)
    for want, got in ((dq32, dq), (dk32, dk), (dv32, dv)):
        tolerance.check_kernel("flash_attention_bwd", want.bfloat16(), got)
    qf, dof = q.clone(), do.clone()
    qf[:, :, -64:] = 0
    dof[:, :, -64:] = 0
    _, dk_f, dv_f = flash_attention_bwd_kernel_plain(qf, k, v, dof, lse,
                                                     delta, True)
    kf = k.clone()
    kf[:, :, :fa.BWD_KEY_TILE] = 0
    dq_f = flash_attention_bwd_kernel_plain(q, kf, v, do, lse, delta,
                                            True)[0]
    for got, want in ((dk_f, dk), (dv_f, dv), (dq_f, dq)):
        with pytest.raises(AssertionError, match="row-relative error"):
            tolerance.check_kernel("flash_attention_bwd", got, want)
    tolerance.check_kernel("flash_attention_bwd_delta",
                           (do.double() * o.double()).sum(-1), delta)
    delta_f = delta.clone()
    delta_f[..., 100] = 0
    with pytest.raises(AssertionError, match="row-relative error"):
        tolerance.check_kernel("flash_attention_bwd_delta", delta_f, delta)


# -- the kernel's launch, mirrored ----------------------------------------

# (S, B, H): the walk's shapes, from a 16-row head to the long-S row
WALK_SHAPES = [(16, 1, 4), (200, 1, 8), (1024, 8, 20), (2048, 2, 32),
               (8192, 1, 4)]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,B,H", WALK_SHAPES)
def test_bwd_walk_takes_every_item_once_longest_first(S, B, H, D):
    g = fa.bwd_geometry(S, D, H, B)
    walk = fa.bwd_walk(S, D, H, B)
    assert sorted(walk) == [(bh, kt) for bh in range(B * H)
                            for kt in range(g.key_tiles)]
    taken = sorted(w for block in fa.bwd_blocks(S, D, H, B) for w in block)
    assert taken == list(range(g.items))
    assert g.grid == min(g.items, 132)
    # heads in groups whose Q, dO and dq sums fit in the L2 (24 MiB, or 48
    # to span whole rounds; all heads when they fit), in a group its
    # longest items first
    assert 1 <= g.group <= B * H
    assert g.group == B * H or g.group * (8 * S * D + 8 * S) <= 48 << 20
    per_group = g.group * g.key_tiles
    for start in range(0, g.items, per_group):
        block = walk[start:start + per_group]
        heads = {bh for bh, _ in block}
        assert heads == set(range(start // g.key_tiles,
                                  start // g.key_tiles + len(heads)))
        lengths = [fa.bwd_item_q_tiles(S, kt, True) for _, kt in block]
        assert lengths == sorted(lengths, reverse=True)
        assert min(lengths) >= 1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,B,H", WALK_SHAPES)
def test_bwd_blocks_stay_balanced(S, B, H, D, causal):
    """Each block's q tiles within 10 % of the mean, or within one
    longest item of it."""
    walk = fa.bwd_walk(S, D, H, B)
    loads = [sum(fa.bwd_item_q_tiles(S, walk[w][1], causal) for w in block)
             for block in fa.bwd_blocks(S, D, H, B)]
    mean = sum(loads) / len(loads)
    longest = fa.bwd_item_q_tiles(S, 0, causal)
    assert max(loads) <= max(1.1 * mean, mean + longest)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,B,H", WALK_SHAPES)
def test_bwd_dq_waits_point_backwards_in_the_walk(S, B, H, D, causal):
    """The dQ writer's every ordered wait is on an item of smaller walk
    index (so the persistent grid, each block taking its items in walk
    order, cannot deadlock), and a q tile's key tiles add in ascending
    order, each after the one before it."""
    g = fa.bwd_geometry(S, D, H, B)
    walk = fa.bwd_walk(S, D, H, B)
    waits = fa.bwd_dq_waits(S, D, H, B, causal)
    assert all(waited < waiting for waiting, waited, _, _ in waits)
    for waiting, waited, bh, i in waits:
        (wbh, kt), (pbh, pkt) = walk[waiting], walk[waited]
        assert wbh == pbh == bh and pkt == kt - 1
        assert i >= fa._bwd_first_q_tile(kt, causal)
    # every contribution of a key tile after the first waits once
    contributions = sum(fa.bwd_item_q_tiles(S, kt, causal)
                        for _, kt in walk if kt > 0)
    assert len(waits) == contributions
    for bh in range(min(B * H, 3)):
        for i in range(g.q_tiles):
            last = fa._bwd_last_key_tile(i, g.key_tiles, causal)
            adds = [kt for (b, kt) in walk
                    if b == bh and fa._bwd_first_q_tile(kt, causal) <= i]
            assert adds == list(range(last + 1))


@pytest.mark.parametrize("D", [64, 128])
def test_bwd_geometry_fits_shared_memory(D):
    g = fa.bwd_geometry(1024, D, 20, 8)
    assert g.smem <= SMEM_LIMIT
    assert (g.kv_stages, g.q_stages, g.dq_stages) == (
        (2, 4, 3) if D == 64 else (1, 2, 2))
    assert g.threads == 384 and g.q_tile == 64 and g.key_tile == 128
    with pytest.raises(ValueError):
        fa.bwd_geometry(1024, 32, 20, 8)


# -- the kernel's arithmetic in its order, against JAX ----------------------

# (S, D, causal, H, Hkv, block): block divides S for JAX's kernels; the
# chunked route takes chunk = block
TILE_CASES = [(128, 64, True, 2, 2, 64), (256, 64, False, 2, 2, 64),
              (200, 64, True, 2, 2, 40), (192, 128, True, 2, 2, 64),
              (130, 128, False, 2, 2, 65), (320, 64, True, 4, 2, 64),
              (256, 128, True, 4, 1, 64)]


def _jax_bwd(route, q, k, v, o, lse, do, causal, block):
    """(dq, dk, dv) of JAX's ``_flash_bwd`` or ``_flash_bwd_chunked`` in
    interpret mode on [B, H, S, D] numpy inputs with full-head K/V."""
    jax, jfa = _jax()
    B, H, S, D = q.shape
    flat = [np.asarray(a, np.float32).reshape(B * H, S, D)
            for a in (q, k, v, o, do)]
    lse3 = np.asarray(lse, np.float32).reshape(B * H, S, 1)
    args = (*flat[:4], lse3, flat[4], 1.0 / np.sqrt(D), causal, block, block)
    if route == "chunked":
        out = jfa._flash_bwd_chunked(*args, block, True)
    else:
        out = jfa._flash_bwd(*args, True)
    return [np.asarray(t).reshape(B, H, S, D) for t in out]


@pytest.mark.parametrize("route", ["whole", "chunked"])
@pytest.mark.parametrize("S,D,causal,H,Hkv,block", TILE_CASES)
def test_tile_emulation_matches_pallas(S, D, causal, H, Hkv, block, route):
    q, k, v, do = (t32(a) for a in _inputs(S, H, Hkv, D=D, B=1))
    o, lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    rep = H // Hkv
    kr, vr = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    delta = flash_attention_bwd_delta_plain(o, do)
    got = fa.flash_attention_bwd_kernel_tiles(q, kr, vr, do, lse, delta,
                                              causal)
    want = _jax_bwd(route, q.numpy(), kr.numpy(), vr.numpy(), o.numpy(),
                    lse.numpy(), do.numpy(), causal, block)
    for g_, w_ in zip(got, want):
        assert_close(g_, w_)


@pytest.mark.parametrize("S,D,causal,H,Hkv,block", TILE_CASES)
def test_tile_emulation_through_the_wrapper_matches_plain(S, D, causal, H,
                                                          Hkv, block):
    """The emulation with the wrapper's GQA repeat and sum, against the
    plain backward over whole rows."""
    q, k, v, do = (t32(a) for a in _inputs(S, H, Hkv, D=D, B=2))
    o, lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    got = flash_attention_bwd_tiles(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    for g_, w_ in zip(got, want):
        assert_close(g_, w_)


@pytest.mark.parametrize("S,D", [(200, 64), (130, 128)])
def test_delta_plain_matches_jax(S, D):
    import jax.numpy as jnp
    _, _, _, do = _inputs(S, 2, 2, D=D)
    o = np.random.RandomState(1).randn(*do.shape).astype(np.float32)
    want = jnp.sum(jnp.asarray(do).astype(jnp.float32)
                   * jnp.asarray(o).astype(jnp.float32), axis=-1)
    got = flash_attention_bwd_delta(t32(o), t32(do))   # CPU: the plain one
    assert_close(got, np.asarray(want))


# -- on the card ------------------------------------------------------------

GPU_CASES = [(1024, 20, True, 64), (200, 8, False, 64), (8192, 2, True, 64),
             (16, 4, True, 64), (2048, 8, True, 128), (333, 4, False, 128),
             (130, 4, True, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,causal,D", GPU_CASES)
def test_cuda_flash_backward_matches_plain(cuda_device, S, H, causal, D):
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _inputs(S, H, H, D=D, B=1))
    o, lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    n_bwd = builder.launches["flash_attention_bwd"]
    n_delta = builder.launches["flash_attention_bwd_delta"]
    delta = flash_attention_bwd_delta(o, do)
    dq, dk, dv = flash_attention_bwd_kernel(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert builder.launches["flash_attention_bwd"] == n_bwd + 1
    assert builder.launches["flash_attention_bwd_delta"] == n_delta + 1
    delta_p = flash_attention_bwd_delta_plain(o, do)
    tolerance.check_kernel("flash_attention_bwd_delta", delta, delta_p)
    want = flash_attention_bwd_kernel_plain(q, k, v, do, lse, delta_p,
                                            causal)
    for got, w in zip((dq, dk, dv), want):
        tolerance.check_kernel("flash_attention_bwd", got, w)
    # planted faults the same checks must reject: the last 16 query rows'
    # contribution dropped from dk, the first 16 keys dropped from dq
    qf, dof, kf = q.clone(), do.clone(), k.clone()
    qf[:, :, -16:] = 0
    dof[:, :, -16:] = 0
    kf[:, :, :16] = 0
    with pytest.raises(AssertionError, match="row-relative error"):
        tolerance.check_kernel("flash_attention_bwd", dk,
                               flash_attention_bwd_kernel_plain(
                                   qf, k, v, dof, lse, delta_p, causal)[1])
    with pytest.raises(AssertionError, match="row-relative error"):
        tolerance.check_kernel("flash_attention_bwd", dq,
                               flash_attention_bwd_kernel_plain(
                                   q, kf, v, do, lse, delta_p, causal)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,causal,D", [(1024, 20, True, 64),
                                          (333, 4, False, 128)])
def test_cuda_flash_backward_reruns_bit_equal(cuda_device, S, H, causal, D):
    """dq sums in a fixed order, so reruns give the same bits."""
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _inputs(S, H, H, D=D, B=2, seed=3))
    o, lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    delta = flash_attention_bwd_delta(o, do)
    first = flash_attention_bwd_kernel(q, k, v, do, lse, delta, causal)
    for _ in range(3):
        again = flash_attention_bwd_kernel(q, k, v, do, lse, delta, causal)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,Hkv,D", [(320, 8, 2, 64), (512, 32, 8, 128)])
def test_cuda_function_gqa_matches_plain(cuda_device, S, H, Hkv, D):
    """FlashAttentionFunction on the card (forward kernel, delta and
    backward kernels, the GQA repeat and sum) against the plain
    backward."""
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _inputs(S, H, Hkv, D=D, B=2))
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    o = FlashAttentionFunction.apply(qt, kt, vt, True, None)
    got = torch.autograd.grad(o, (qt, kt, vt), do)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=True)
    want = flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal=True)
    for g, w in zip(got, want):
        tolerance.check_kernel("flash_attention_bwd", g, w)


@pytest.mark.gpu
def test_cuda_flash_backward_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 16, 64, device=cuda_device)
    lse = torch.zeros(1, 2, 16, device=cuda_device)
    with pytest.raises(NotImplementedError):
        flash_attention_bwd_kernel(q, q, q, q, lse, lse)      # fp32
    with pytest.raises(NotImplementedError):
        flash_attention_bwd(q, q, q, q, lse, q)               # fp32
    qb = torch.zeros(1, 2, 16, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        flash_attention_bwd_kernel(qb, qb, qb, qb, lse, lse)  # head dim 32
    with pytest.raises(NotImplementedError):
        flash_attention_bwd_delta(qb, qb)                     # head dim 32


@pytest.mark.gpu
def test_cuda_train_batch_runs_through_the_kernels(cuda_device):
    """initialize + train_batch on the card: a 2-layer GPT-2 of head dim
    64 launches the forward, the delta and the backward kernel once per
    layer and step, and its loss falls."""
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
    assert dict(builder.launches) == {
        "flash_attention_fwd": 8, "flash_attention_bwd": 8,
        "flash_attention_bwd_delta": 8}
