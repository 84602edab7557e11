"""deepspeed_tpu_torch grouped quantization vs the JAX package.

``quantize_plain`` (what a CPU tensor runs) against JAX's ``quantize``
(the Pallas kernel in interpret mode, as tests/test_quantize.py runs it)
bit for bit, including a layer-sized case where JAX's own
``quantize_jnp`` parts from it; the storage quantizers bit for bit; the
``ds_quantizer`` API, the groups error, zero and NaN groups; stochastic
rounding held statistically. On the card, the CUDA kernel against the
plain version bit for bit (nearest) and statistically (stochastic).
"""

import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import quantizer as tq
from deepspeed_tpu_torch.ops.cuda import builder
from deepspeed_tpu_torch.ops.cuda import quantize as cq
from torch_port_common import cuda_device  # noqa: F401


def _jq():
    """JAX's quantize module, imported here and not at the top so the gpu
    tests also run where JAX is not installed."""
    return importlib.import_module("deepspeed_tpu.ops.pallas.quantize")


def _x(shape, seed=0, scale=0.02):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _jax_quantize(x, dtype, **kw):
    jnp = importlib.import_module("jax.numpy")
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    out = _jq().quantize(xj, **kw)
    return np.array(out.astype(jnp.float32)), np.array(
        xj.astype(jnp.float32))


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("bits", [4, 8, 13, 15])
def test_plain_matches_pallas_bit_for_bit(bits, groups, sym, dtype):
    want, x = _jax_quantize(_x((16, 64), seed=bits), dtype, bits=bits,
                            groups=groups, sym=sym)
    got = cq.quantize_plain(torch.from_numpy(x).to(dtype), bits, groups, sym)
    assert got.dtype == dtype and got.shape == (16, 64)
    _bits_equal(got.float(), want)


def test_plain_follows_quantize_where_quantize_jnp_parts():
    """At GPT-2 large's c_attn shape, 8 bits, symmetric, 8 groups, JAX's
    kernel (scale = amax * fl(1/127)) and its jnp reference (amax / 127)
    part in the scale's last bit; the port follows the kernel."""
    x = _x((1280, 3840))
    want, _ = _jax_quantize(x, torch.float32, bits=8, groups=8, sym=True)
    jnp_ref = np.asarray(_jq().quantize_jnp(x, bits=8, groups=8, sym=True))
    assert not np.array_equal(want, jnp_ref)
    _bits_equal(cq.quantize_plain(torch.from_numpy(x), 8, 8, True), want)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits,groups", [(4, 1), (8, 4), (8, 8)])
def test_packed_and_dequantized_match_jax(bits, groups, sym):
    x = _x((16, 64), seed=3)
    q, s, z = _jq().quantize_packed(x, bits, groups, sym)
    tq_, ts, tz = tq.quantize_packed(torch.from_numpy(x), bits, groups, sym)
    assert tq_.dtype == (torch.int8 if sym else torch.uint8)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(q))
    _bits_equal(ts, s)
    if sym:
        assert tz is None and z is None
    else:
        _bits_equal(tz, z)
    _bits_equal(tq.dequantize_packed(tq_, ts, tz, x.shape),
                _jq().dequantize_packed(q, s, z, x.shape))
    with pytest.raises(ValueError, match="at most 8 bits"):
        tq.quantize_packed(torch.from_numpy(x), 9)


def test_ds_quantizer_api_and_the_groups_error():
    x = torch.from_numpy(_x((8, 32), seed=4))
    q = tq.ds_quantizer(x, groups=2, bit_num=8)
    assert q.shape == x.shape and q.dtype == x.dtype
    assert torch.equal(q, cq.quantize(x, 8, 2))
    assert torch.equal(tq.ds_quantizer(x, groups=2, bit_num=6, asym=True),
                       cq.quantize_plain(x, 6, 2, sym=False))
    gen = torch.Generator().manual_seed(0)
    sr = tq.ds_quantizer(x, groups=2, bit_num=4, sr=True, generator=gen)
    assert sr.shape == x.shape and torch.isfinite(sr).all()
    out = torch.empty_like(x)
    assert cq.quantize(x, 8, 2, out=out) is out and torch.equal(out, q)
    jnp = importlib.import_module("jax.numpy")
    with pytest.raises(ValueError) as want:
        _jq().quantize(jnp.zeros((3, 5)), groups=4, interpret=True)
    with pytest.raises(ValueError) as got:
        cq.quantize(torch.zeros(3, 5), groups=4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="bits"):
        cq.quantize(x, bits=17)


@pytest.mark.parametrize("sym", [True, False])
def test_zero_and_nan_groups_match_pallas(sym):
    """An all-zero group (scale 0 → 1) comes back zero; a NaN makes its
    own group NaN and no other (jnp.max propagates it)."""
    x = _x((4, 32), seed=5)
    x[1] = 0.0
    x[2, 7] = np.nan
    want, _ = _jax_quantize(x, torch.float32, bits=8, groups=4, sym=sym)
    got = cq.quantize_plain(torch.from_numpy(x), 8, 4, sym).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]).all() and not np.isnan(got[[0, 1, 3]]).any()
    assert (got[1] == 0).all()
    _bits_equal(got[[0, 1, 3]], want[[0, 1, 3]])


def test_grid_covers_every_group_in_aligned_chunks():
    """The kernel's (blocks a group, chunk): chunks of a multiple of 8
    elements, every block non-empty, the last one ending the group."""
    for groups, n in ((1, 64_389_120), (8, 614_400), (8, 163_840), (1, 7),
                      (3, 2049), (5000, 16), (1, 1)):
        nblk, chunk = cq.grid(groups, n)
        assert chunk % cq.CHUNK_ALIGN == 0 and nblk >= 1
        assert (nblk - 1) * chunk < n <= nblk * chunk
        assert groups * nblk <= max(cq.TARGET_BLOCKS, groups) + groups


def sr_input(bits, sym, fracs=(0.125, 0.25, 0.375)):
    """A group [16, 64] placed at known fractions of a step: t = x /
    scale (symmetric) or (x - min) / scale sits at whole codes plus
    ``fracs``, the range pinned by anchors at the extreme codes. Returns
    (x, t) in fp32."""
    hi = cq.qrange(bits, sym)[1]
    first = -hi if sym else 0.0
    n = 16 * 64
    codes = first + np.arange(n) % int(hi - first)
    frac = np.resize(np.asarray(fracs, np.float64), n)
    step = 2.0 ** -7
    x = ((codes + frac) * step).astype(np.float32)
    x[0], x[1] = hi * step, first * step
    flat = torch.from_numpy(x).reshape(1, -1)
    scale, zero = cq.qparams_plain(flat, bits, sym)
    t = flat / scale if sym else (flat - zero) / scale
    return flat.reshape(16, 64), t.reshape(16, 64)


def sr_stats(draws, x, t, bits, sym):
    """(every code floor(t) or ceil(t) and inside the code range, z of
    the summed code error over elements and draws): each code's error q -
    t has mean 0 and variance f (1 - f), f = t - floor(t)."""
    flat = x.reshape(1, -1).float()
    scale, zero = cq.qparams_plain(flat, bits, sym)
    lo, hi = cq.qrange(bits, sym)
    errs, ok = [], True
    for out in draws:
        o = out.reshape(1, -1).float()
        q = torch.round(o / scale if sym else (o - zero) / scale).reshape(
            t.shape)
        ok &= bool(((q == torch.floor(t)) | (q == torch.ceil(t))).all())
        ok &= lo <= float(q.min()) and float(q.max()) <= hi
        errs.append((q - t).double())
    f = (t - torch.floor(t)).double()
    sigma = float((f * (1 - f)).sum().sqrt()) * len(draws) ** 0.5
    return ok, float(torch.stack(errs).sum()) / max(sigma, 1e-30)


@pytest.mark.parametrize("sym", [True, False])
def test_stochastic_rounding_is_unbiased_and_nearest_is_not(sym):
    """256 draws of the plain version: codes are floor(t) or ceil(t),
    inside the code range, and the summed error is within 4 sigma of 0;
    nearest rounding at the same fractions is far outside. JAX's
    interpret mode (``quantize_jnp`` with the JAX PRNG) passes the same
    check."""
    bits = 4
    x, t = sr_input(bits, sym)
    gen = torch.Generator().manual_seed(0)
    draws = [cq.quantize_plain(x, bits, 1, sym, True, gen)
             for _ in range(256)]
    ok, z = sr_stats(draws, x, t, bits, sym)
    assert ok and abs(z) <= 4.0, z
    _, z_near = sr_stats([cq.quantize_plain(x, bits, 1, sym)] * 256, x, t,
                         bits, sym)
    assert abs(z_near) > 40.0, z_near
    jax = importlib.import_module("jax")
    jdraws = [torch.from_numpy(np.array(_jq().quantize(
        x.numpy(), bits=bits, groups=1, sym=sym, stochastic=True,
        key=jax.random.PRNGKey(i)))) for i in range(256)]
    ok, z = sr_stats(jdraws, x, t, bits, sym)
    assert ok and abs(z) <= 4.0, z


# -- on the card --------------------------------------------------------------

def _gpu_cases():
    # (shape, groups, bits, sym, dtype): sizes no multiple of a block's
    # share or of 8, groups bigger than one block's chunk, bf16
    return [((1280, 5120), 8, 15, True, torch.float32),
            ((1280, 5120), 8, 8, True, torch.float32),
            ((1000, 1283), 1, 8, True, torch.float32),
            ((3, 7, 5), 1, 4, False, torch.float32),
            ((37, 999), 3, 6, False, torch.float32),
            ((4096, 1024), 2, 8, False, torch.bfloat16),
            ((515, 130), 5, 13, True, torch.bfloat16),
            ((64, 64), 64, 8, True, torch.float32)]


@pytest.mark.gpu
def test_cuda_kernel_equals_plain_bit_for_bit(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for shape, groups, bits, sym, dtype in _gpu_cases():
        x = (0.02 * torch.randn(shape, generator=gen,
                                device=cuda_device)).to(dtype)
        n0 = builder.launches["quantize"]
        got = cq.quantize(x, bits, groups, sym)
        torch.cuda.synchronize()
        assert builder.launches["quantize"] == n0 + 1
        want = cq.quantize_plain(x, bits, groups, sym)
        assert got.dtype == dtype
        assert torch.equal(got, want), (shape, groups, bits, sym, dtype)
        inplace = x.clone()
        cq.quantize(inplace, bits, groups, sym, out=inplace)
        assert torch.equal(inplace, want)
        # an unaligned view (4 bytes past an allocation) takes the
        # scalar path
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
        xv = buf[1:].view(shape)
        xv.copy_(x)
        assert torch.equal(cq.quantize(xv, bits, groups, sym), want)


@pytest.mark.gpu
def test_cuda_kernel_zero_and_nan_groups(cuda_device):
    x = torch.from_numpy(_x((4, 4096), seed=5)).to(cuda_device)
    x[1] = 0.0
    x[2, 3001] = float("nan")
    for sym in (True, False):
        got = cq.quantize(x, 8, 4, sym)
        want = cq.quantize_plain(x, 8, 4, sym)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.isnan(got[2]).all() and (got[1] == 0).all()
        assert torch.equal(got[[0, 1, 3]], want[[0, 1, 3]])


@pytest.mark.gpu
def test_cuda_stochastic_rounding_is_unbiased(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for sym in (True, False):
        x, t = sr_input(4, sym)
        x, t = x.to(cuda_device), t.to(cuda_device)
        draws = [cq.quantize(x, 4, 1, sym, True, gen) for _ in range(256)]
        ok, z = sr_stats(draws, x, t, 4, sym)
        assert ok and abs(z) <= 4.0, z
        assert not torch.equal(draws[0], draws[1])
