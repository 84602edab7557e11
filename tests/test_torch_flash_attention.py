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
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda.decode import MAX_SMEM
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain, fwd_geometry)
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


# ------------------------------- the TMA forward's launch, mirrored in Python

# (D, K stages, V stages, shared memory bytes a block): csrc/
# flash_attention.cu FwdCfg; Q and O 128 rows, K and V tiles of 128 keys,
# D / 64 boxes a row
FWD_SMEM = {64: (4, 4, 165120), 128: (2, 3, 230656)}
# the main paths' launches, (S, D, H, Hkv, B): q tiles, heads a group,
# tiles
FWD_LAUNCH = {(1024, 64, 20, 20, 1): (8, 20, 160),      # GPT-2 prefill
              (1024, 64, 20, 20, 8): (8, 66, 1280),     # GPT-2 train
              (1024, 64, 20, 20, 2): (8, 40, 320),      # ZeRO-3 rank
              (1024, 128, 32, 32, 1): (8, 32, 256),     # LLaMA-7B prefill
              (2048, 128, 32, 32, 8): (16, 24, 4096),   # fast-path prompt
              (8192, 64, 4, 4, 1): (64, 4, 256),        # long S
              (1024, 128, 32, 8, 1): (8, 32, 256)}      # LLaMA-3-8B GQA


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 16, 63, 65, 1000, 1024, 2048, 8192])
def test_fwd_geometry_follows_the_launch(D, S):
    """128-row q tiles over 128-key tiles, 384 threads (a producer and two
    consumer warpgroups), stages and shared memory as the kernel lays them
    out: within a block's 227 KiB, every TMA destination 1024-byte
    aligned (the 128-byte swizzle's atom); heads grouped by their K/V
    bytes against 24 MiB of L2."""
    g = fwd_geometry(S, D, 20, 4, 8)
    k_stages, v_stages, smem = FWD_SMEM[D]
    assert (g.q_tile, g.key_tile, g.threads) == (128, 128, 384)
    assert g.q_tiles == -(-S // 128) and g.tiles == g.q_tiles * 160
    assert g.grid == min(g.tiles, 132)       # persistent: one block an SM
    assert (g.k_stages, g.v_stages, g.smem) == (k_stages, v_stages, smem)
    assert g.smem <= MAX_SMEM
    q_bytes, kv_bytes = g.q_tile * D * 2, g.key_tile * D * 2
    assert q_bytes % 1024 == 0 and kv_bytes % 1024 == 0
    assert g.smem == (1024 + 2 * q_bytes
                      + (g.k_stages + g.v_stages) * kv_bytes + 256)
    # all 160 heads when their K/V fit in 24 MiB, else the most that fit
    # in whole rounds of the grid (a multiple of grid / gcd(grid, q tiles))
    fit = (24 << 20) // (4 * S * D * 4 // 20)
    unit = g.grid // math.gcd(g.grid, g.q_tiles)
    assert g.group == (160 if fit >= 160 else fit // unit * unit
                       if fit >= unit else max(fit, 1))
    with pytest.raises(ValueError, match="head dim"):
        fwd_geometry(S, 96, 1, 1)


@pytest.mark.parametrize("shape", sorted(FWD_LAUNCH))
def test_fwd_walk_takes_every_tile_once_longest_first(shape):
    """Each (b*h, q tile) once; the heads in groups of ``group``, and in a
    group the q tiles longest first; every tile taken by one persistent
    block, and no block's share of the key tiles more than 10 % over the
    mean, or over the longest tile."""
    S, D, H, Hkv, B = shape
    g = fwd_geometry(*shape)
    assert (g.q_tiles, g.group, g.tiles) == FWD_LAUNCH[shape]
    walk = fa.fwd_walk(*shape)
    assert sorted(walk) == [(bh, qt) for bh in range(B * H)
                            for qt in range(g.q_tiles)]
    per_group = g.group * g.q_tiles
    for start in range(0, len(walk), per_group):
        chunk = walk[start:start + per_group]
        assert {bh // g.group for bh, _ in chunk} == {start // per_group}
        qts = [qt for _, qt in chunk]
        assert qts == sorted(qts, reverse=True)
    blocks = fa.fwd_blocks(*shape)
    assert sorted(w for ws in blocks for w in ws) == list(range(g.tiles))
    loads = [sum(walk[w][1] + 1 for w in ws) for ws in blocks]
    mean = sum(loads) / len(loads)
    assert max(loads) <= max(g.q_tiles, 1.1 * mean)


# ------------------------------------------------------------ on the card

# every S the q and key tiles cut differently: one row, a bucket, either
# side of 64, a ragged tail, whole tiles; GQA with 4 q heads a kv head
CUDA_S = [1, 16, 63, 65, 1000, 1024, 2048]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", CUDA_S)
def test_cuda_tma_flash_matches_plain(cuda_device, S, causal, D):
    rs = np.random.RandomState(S)
    q = torch.from_numpy(rs.randn(1, 32, S, D).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(1, 8, S, D).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    n0 = builder.launches["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert builder.launches["flash_attention_fwd"] == n0 + 1
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=causal)
    key = "flash_attention_fwd" if D == 64 else "flash_attention_fwd[d128]"
    tolerance.check_kernel(key, o, o_ref)
    tolerance.check_lse(lse, lse_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_cuda_tma_flash_is_deterministic_with_either_turn_setting(
        cuda_device, D, monkeypatch):
    """Three reruns equal the first bit for bit, and so does the kernel
    with the other turn-taking setting (the same products in the same
    order)."""
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(2, 8, 700, D).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for _ in range(3))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    for _ in range(3):
        o2, lse2 = flash_attention_fwd(q, k, v, causal=True)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
    monkeypatch.setattr(fa, "PINGPONG", {D: not fa.PINGPONG[D]})
    o3, lse3 = flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(o, o3) and torch.equal(lse, lse3)


@pytest.mark.gpu
def test_cuda_tma_flash_takes_an_unaligned_view(cuda_device):
    """A contiguous view at an offset TMA cannot describe (2 bytes past
    an aligned base) is copied, not refused."""
    rs = np.random.RandomState(4)
    n = 2 * 4 * 130 * 64
    flat = torch.from_numpy(rs.randn(3 * n + 1).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(2, 4, 130, 64)
               for i in range(3))
    assert q.data_ptr() % 16
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=True)
    tolerance.check_kernel("flash_attention_fwd", o, o_ref)
    tolerance.check_lse(lse, lse_ref)
