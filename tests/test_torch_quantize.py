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


# -- the table of leaves and its work list -------------------------------------

def _random_table(seed):
    """[(piece numels, element bytes, groups)]: 1-5 pieces a leaf (some
    empty), 1-8 groups, fp32 or bf16 element sizes."""
    rs = np.random.RandomState(seed)
    leaves = []
    for _ in range(rs.randint(1, 7)):
        groups = int(rs.choice([1, 2, 3, 8]))
        total = groups * int(rs.randint(1, 400))
        cuts = np.sort(rs.randint(0, total + 1, rs.randint(0, 5)))
        numels = np.diff(np.concatenate([[0], cuts, [total]])).tolist()
        leaves.append((numels, int(rs.choice([2, 4])), groups))
    return leaves


def _tickets_hold(leaves, wl, tile_bytes, window_bytes):
    """The work list's properties: every element of every group in
    exactly one R tile and one A tile; no tile straddles a piece or a
    group; every A tile after all R tiles of its group; windows of
    consecutive whole groups within the budget (or one group)."""
    numel, esize, leaf_off, n, g0 = [], [], [], [], []
    g = 0
    for numels, es, groups in leaves:
        off = np.concatenate([[0], np.cumsum(numels)[:-1]])
        for k, m in enumerate(numels):
            numel.append(m)
            esize.append(es)
            leaf_off.append(int(off[k]))
            n.append(sum(numels) // groups)
            g0.append(g)
        g += groups
    numel, esize, leaf_off, n, g0 = map(np.asarray, (numel, esize, leaf_off,
                                                     n, g0))
    p, st, ct = wl.piece, wl.start, wl.count
    assert (ct >= 1).all() and (ct * esize[p] <= tile_bytes).all()
    assert (st >= 0).all() and (st + ct <= numel[p]).all()
    first = (leaf_off[p] + st) // n[p]
    assert (first == (leaf_off[p] + st + ct - 1) // n[p]).all()
    assert (wl.group == g0[p] + first).all()
    for kind in (0, 1):
        sel = wl.kind == kind
        o = np.lexsort((st[sel], p[sel]))
        ps, ss, cs = p[sel][o], st[sel][o], ct[sel][o]
        for piece in range(len(numel)):
            here = ps == piece
            ends = np.concatenate([[0], (ss + cs)[here]])
            assert (ss[here] == ends[:-1]).all()
            assert ends[-1] == numel[piece]
    pos = np.arange(len(wl.kind))
    last_r = np.full(g, -1)
    np.maximum.at(last_r, wl.group[wl.kind == 0], pos[wl.kind == 0])
    first_a = np.full(g, len(pos))
    np.minimum.at(first_a, wl.group[wl.kind == 1], pos[wl.kind == 1])
    assert (last_r < first_a).all() and (last_r >= 0).all()
    assert (wl.need == np.bincount(wl.group[wl.kind == 0],
                                   minlength=g)).all()
    assert wl.window[0] == 0 and set(np.diff(wl.window)) <= {0, 1}
    for w in range(int(wl.window.max()) + 1):
        in_w = wl.window == w
        assert in_w.sum() == 1 or wl.group_bytes[in_w].sum() <= window_bytes


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("lag", [0, 3, 10 ** 9])
def test_work_list_covers_each_element_once_in_order(seed, lag):
    """Random tables, small tiles and windows: the ticket order's
    properties hold whatever the lag (10^9: each window's A tiles after
    all of the next window's R tiles)."""
    leaves = _random_table(seed)
    tile_bytes, window_bytes = 64 * (1 + seed % 3), 900
    wl = cq.work_list(leaves, tile_bytes, window_bytes, lag)
    _tickets_hold(leaves, wl, tile_bytes, window_bytes)


def test_work_list_at_the_moq_boundary_shapes():
    """GPT-2 large's leaf shapes at the module's constants: wte's 32 MB
    groups are windows of their own, c_fc's groups share windows, each
    window's A tiles trail the next window's R tiles by LAG_TILES."""
    wte, c_fc = 50304 * 1280, 1280 * 5120
    leaves = [([wte], 4, 8), ([c_fc], 4, 8), ([1280] * 36, 4, 8),
              ([c_fc], 2, 8)]
    wl = cq.work_list(leaves)
    _tickets_hold(leaves, wl, cq.TILE_BYTES, cq.WINDOW_BYTES)
    assert (wl.window[:8] == np.arange(8)).all()
    assert len(set(wl.window[8:16].tolist())) < 8
    # the first A tile of window 0 follows window 0's R tiles and
    # LAG_TILES + 1 of window 1's (a tie goes to the R tile); a 32 MB
    # group's A tiles run from its last R tile back
    a0 = int(np.argmax(wl.kind == 1))
    r_before = int((wl.kind[:a0] == 0).sum())
    assert r_before == int(wl.need[0]) + cq.LAG_TILES + 1
    a = np.nonzero((wl.kind == 1) & (wl.group == 0))[0]
    assert (np.diff(wl.start[a]) < 0).all()


def test_launch_split_keeps_table_order_and_counts():
    """Past ``max_tickets`` a table splits between leaves, in order."""
    assert cq.launch_split([3, 1, 4, 1, 5], max_tickets=10) == [
        (0, 2), (2, 4), (4, 5)]
    assert cq.launch_split([3, 1, 4]) == [(0, 3)]
    with pytest.raises(NotImplementedError, match="tickets"):
        cq.launch_split([3, 9], max_tickets=10)


def _jax_leaf(pieces, **kw):
    jnp = importlib.import_module("jax.numpy")
    leaf = np.stack(pieces) if len(pieces) > 1 else pieces[0]
    return np.array(_jq().quantize(jnp.asarray(leaf), **kw)).reshape(-1)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("bits", [4, 8, 15])
def test_quantize_leaves_plain_matches_jax_leaf_for_leaf(bits, groups, sym):
    """A table of an unstacked [16, 64] leaf and a stacked [3, 64] leaf
    given as its three pieces: each leaf bit for bit JAX's ``quantize``
    of the whole leaf (tolerance 0), in place and into outputs."""
    flat = [_x((16, 64), seed=bits)]
    stacked = [_x((64,), seed=bits + k, scale=0.01 * (k + 1))
               for k in range(3)]
    table = [([torch.from_numpy(a.copy()) for a in flat], bits, groups),
             ([torch.from_numpy(a.copy()) for a in stacked], bits, groups)]
    outs = [[torch.empty_like(p) for p in pieces] for pieces, _, _ in table]
    cq.quantize_leaves(table, sym=sym, outs=outs)
    cq.quantize_leaves(table, sym=sym)
    for (pieces, _, _), dst, src in zip(table, outs, (flat, stacked)):
        want = _jax_leaf(src, bits=bits, groups=groups, sym=sym)
        _bits_equal(torch.cat([p.reshape(-1) for p in pieces]), want)
        _bits_equal(torch.cat([d.reshape(-1) for d in dst]), want)


@pytest.mark.parametrize("r", [0.75, 0.5, 0.3, 1.0 / 3.0])
def test_blend_epilogue_is_the_three_ops_bit_for_bit(r):
    """The kernel's blend, fl(fl(x·fp32(r)) + fl(q·fp32(1 - r))) in fp32
    (numpy here), equals the torch sequence q.mul_(1 - r),
    x.mul_(r).add_(q) and JAX's r * x + (1.0 - r) * q bit for bit, and
    ``quantize_leaves_plain``'s blend is that of a quantized q."""
    jnp = importlib.import_module("jax.numpy")
    x = _x((64, 32), seed=7)
    q = _x((64, 32), seed=8)
    epilogue = x * np.float32(r) + q * np.float32(1.0 - r)
    assert epilogue.dtype == np.float32
    tq_, tx = torch.from_numpy(q.copy()), torch.from_numpy(x.copy())
    tq_.mul_(1.0 - r)
    tx.mul_(r).add_(tq_)
    _bits_equal(tx, epilogue)
    _bits_equal(np.asarray(r * jnp.asarray(x) + (1.0 - r) * jnp.asarray(q)),
                epilogue)
    table = [([torch.from_numpy(x.copy())], 8, 4)]
    cq.quantize_leaves(table, sym=True, ratio=r)
    qx = cq.quantize_plain(torch.from_numpy(x), 8, 4).numpy()
    _bits_equal(table[0][0][0], x * np.float32(r)
                + qx * np.float32(1.0 - r))


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


def _table(device, gen, sizes):
    """A table [(pieces, bits, groups)] on ``device``: ``sizes`` is
    [(piece shapes, dtype, bits, groups, offset)]; a piece with offset 1
    starts one element past an allocation (not 16-byte aligned)."""
    table = []
    for shapes, dtype, bits, groups, off in sizes:
        pieces = []
        for shape in shapes:
            n = int(np.prod(shape))
            buf = (0.02 * torch.randn(n + off, generator=gen,
                                      device=device)).to(dtype)
            pieces.append(buf[off:].view(shape))
        table.append((pieces, bits, groups))
    return table


def _mixed_sizes(big):
    """Unaligned pieces, groups smaller than a tile, a stacked leaf of 36
    pieces, a group larger than a window (``big``), fp32 and bf16."""
    return [([(1000, 1283)], torch.float32, 8, 1, 1),
            ([(37, 999)], torch.float32, 6, 3, 1),
            ([(64, 64)], torch.float32, 8, 64, 0),
            ([(1280,)] * 36, torch.float32, 15, 8, 0),
            ([(515, 130)], torch.bfloat16, 13, 5, 1),
            ([(4096, 1024)], torch.bfloat16, 8, 2, 0),
            ([(3, 7, 5), (11,), (0,), (4,)], torch.float32, 4, 1, 1),
            ([(big,)], torch.float32, 12, 1, 0)]


def _leaf_equal(leaf, got, sym, ratio=None):
    pieces, bits, groups = leaf
    want = cq.quantize_leaves_plain(
        [leaf], sym, ratio=ratio,
        outs=[[torch.empty_like(p) for p in pieces]])[0]
    for g, w in zip(got, want):
        assert torch.equal(g, w), (tuple(pieces[0].shape), bits, groups)


@pytest.mark.gpu
def test_cuda_leaves_mixed_table_bit_for_bit(cuda_device, monkeypatch):
    """One launch over a mixed table, symmetric and asymmetric, into
    outputs and in place: every leaf bit for bit the plain version's.
    Also with windows of 1 MB and a lag of 0, so that many windows
    follow each other and A tiles trail closely."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    big = 6 << 20          # 24 MB of fp32 in one group
    table = _table(cuda_device, gen, _mixed_sizes(big))
    for window, lag in ((None, None), (1 << 20, 0)):
        if window:
            monkeypatch.setattr(cq, "WINDOW_BYTES", window)
            monkeypatch.setattr(cq, "LAG_TILES", lag)
        for sym in (True, False):
            outs = [[torch.empty_like(p) for p in pieces]
                    for pieces, _, _ in table]
            n0 = builder.launches["quantize"]
            cq.quantize_leaves(table, sym, outs=outs)
            torch.cuda.synchronize()
            assert builder.launches["quantize"] == n0 + 1
            for leaf, got in zip(table, outs):
                _leaf_equal(leaf, got, sym)
    # in place
    inplace = [([p.clone() for p in pieces], bits, groups)
               for pieces, bits, groups in table]
    cq.quantize_leaves(inplace, False)
    for leaf, (got, _, _) in zip(table, inplace):
        _leaf_equal(leaf, got, False)


@pytest.mark.gpu
def test_cuda_leaves_zero_and_nan_groups(cuda_device):
    """In one table: an all-zero group comes back zero, a NaN makes its
    own group NaN and no other, the other leaves bit for bit."""
    x = torch.from_numpy(_x((4, 4096), seed=5)).to(cuda_device)
    x[1] = 0.0
    x[2, 3001] = float("nan")
    y = torch.from_numpy(_x((8, 1000), seed=6)).to(cuda_device)
    for sym in (True, False):
        table = [([x], 8, 4), ([y], 8, 2)]
        outs = [[torch.empty_like(x)], [torch.empty_like(y)]]
        cq.quantize_leaves(table, sym, outs=outs)
        got = outs[0][0]
        want = cq.quantize_plain(x, 8, 4, sym)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.isnan(got[2]).all() and (got[1] == 0).all()
        assert torch.equal(got[[0, 1, 3]], want[[0, 1, 3]])
        assert torch.equal(outs[1][0], cq.quantize_plain(y, 8, 2, sym))


@pytest.mark.gpu
def test_cuda_leaves_blend_bit_for_bit(cuda_device):
    """The blend inside the kernel, fp32 and bf16, symmetric and not, at
    the ratios MoQ's schedule takes: bit for bit the plain sequence."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    table = _table(cuda_device, gen, _mixed_sizes(1 << 16))
    for ratio in (0.75, 0.5, 0.25, 0.3):
        for sym in (True, False):
            outs = [[torch.empty_like(p) for p in pieces]
                    for pieces, _, _ in table]
            cq.quantize_leaves(table, sym, ratio=ratio, outs=outs)
            for leaf, got in zip(table, outs):
                _leaf_equal(leaf, got, sym, ratio)


@pytest.mark.gpu
def test_cuda_leaves_stochastic_per_leaf(cuda_device):
    """Stochastic rounding over a table of four leaves (one of them
    stacked as 16 pieces) held per leaf: codes floor(t) or ceil(t), the
    summed error within 4 sigma over 256 draws; the same values in
    two leaves (each its own seed) and in two draws come out apart."""
    for sym in (True, False):
        x, t = sr_input(4, sym)
        x, t = x.to(cuda_device), t.to(cuda_device)
        draws = [[] for _ in range(4)]
        gen = torch.Generator(device=cuda_device).manual_seed(2)
        for _ in range(256):
            table = [([x.clone()], 4, 1), (list(x.clone().unbind(0)), 4, 1),
                     ([x.clone()], 4, 1), ([x.clone()], 4, 1)]
            cq.quantize_leaves(table, sym, True, generator=gen)
            for k, (pieces, _, _) in enumerate(table):
                draws[k].append(torch.stack(pieces).reshape(16, 64))
        for ds in draws:
            ok, z = sr_stats(ds, x, t, 4, sym)
            assert ok and abs(z) <= 4.0, z
            assert not torch.equal(ds[0], ds[1])
        assert not torch.equal(draws[0][0], draws[2][0])
