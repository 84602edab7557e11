"""deepspeed_tpu_torch's fused all-gather+matmul and matmul+reduce-scatter
vs the JAX package, on the CPU.

The plain versions take the list of the n ranks' shards (the kernels'
pointer-table contract) and are held against JAX's ``backend="lax"`` ring
(``deepspeed_tpu/ops/pallas/fused_collective.py``) under ``shard_map`` on
the 8 virtual CPU devices, rank by rank (each rank its own x rows, so its
own ring order), and against a dense product: every shard dim x
transpose variant, mesh sizes 2, 4 and 8, uneven chunks, fp32 at 2e-5
and bf16 at 5e-2. The custom backward's contract (dx by the transposed
all-gather+matmul, dW the shard-shaped SUM by matmul+reduce-scatter) is
held against dense autograd. The TMA kernel's tile walk (``tile_plan``)
is emulated tile by tile in torch, TMA's zero-filled boxes and the
epilogue's chunk addressing included, against the plain versions and
JAX's lax ring; the ring order of its k tiles, its chunk-aligned N tiles
and the shape test that picks the TMA or the mma.sync kernel are pinned.
On the card, two ranks share a symmetric heap and each kernel is held
against its plain version on both routes. JAX is imported inside the
tests, so the gpu test runs where JAX is not installed.
"""

import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import fused_collective as fc
from deepspeed_tpu_torch.ops.cuda import fused_collective as k
from torch_port_common import FP32_ATOL, FP32_RTOL, cuda_device  # noqa: F401

BF16_TOL = 5e-2


def _jax():
    jax = importlib.import_module("jax")
    jnp = importlib.import_module("jax.numpy")
    jfc = importlib.import_module("deepspeed_tpu.ops.pallas.fused_collective")
    mesh_lib = importlib.import_module("deepspeed_tpu.parallel.mesh")
    sharding = importlib.import_module("jax.sharding")
    return jax, jnp, jfc, mesh_lib, sharding


def _jdtype(dtype):
    jnp = importlib.import_module("jax.numpy")
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _shards(w, shard_dim, n):
    return list(torch.chunk(w, n, dim=shard_dim))


def _jax_ag(x, w, n, shard_dim, transpose_w, dtype):
    """JAX's lax all-gather+matmul, x rows split over n devices (device r
    takes rows r*M/n..), fp32 out: [n*M/n, N] in device order."""
    jax, jnp, jfc, mesh_lib, sharding = _jax()
    P = sharding.PartitionSpec
    mesh = sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))
    cfg = jfc.CollectiveMatmulConfig(axis_name="data", axis_size=n,
                                     backend="lax", min_shard_bytes=0)

    def f(x_l, w_l):
        return jfc.all_gather_matmul(
            x_l, w_l, shard_dim=shard_dim, axis_name="data", axis_size=n,
            transpose_w=transpose_w, cfg=cfg, out_dtype=jnp.float32)

    wspec = P("data", None) if shard_dim == 0 else P(None, "data")
    g = jax.jit(mesh_lib.shard_map(f, mesh=mesh,
                                   in_specs=(P("data", None), wspec),
                                   out_specs=P("data", None),
                                   check_vma=False))
    jd = _jdtype(dtype)
    return np.asarray(g(jnp.asarray(x.float().numpy()).astype(jd),
                        jnp.asarray(w.float().numpy()).astype(jd)))


def _port_ag(x, w, n, shard_dim, transpose_w):
    shards = _shards(w, shard_dim, n)
    rows = x.shape[0] // n
    return torch.cat([k.ag_matmul(x[r * rows:(r + 1) * rows], shards, r,
                                  shard_dim, transpose_w,
                                  out_dtype=torch.float32)
                      for r in range(n)])


def _ag_case(n, shard_dim, transpose_w, dtype=torch.float32, M=32, K=48,
             N=64, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n * M, N if transpose_w else K)
                         .astype(np.float32) * 0.1).to(dtype)
    w = torch.from_numpy(rng.randn(K, N).astype(np.float32) * 0.1).to(dtype)
    got = _port_ag(x, w, n, shard_dim, transpose_w)
    want = _jax_ag(x, w, n, shard_dim, transpose_w, dtype)
    dense = x.float() @ (w.float().t() if transpose_w else w.float())
    tol = FP32_ATOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=FP32_RTOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=tol,
                               rtol=FP32_RTOL)


@pytest.mark.parametrize("shard_dim", [0, 1])
@pytest.mark.parametrize("transpose_w", [False, True])
def test_ag_matmul_plain_matches_jax_lax_and_dense(shard_dim, transpose_w):
    _ag_case(4, shard_dim, transpose_w)


@pytest.mark.parametrize("n", [2, 8])
def test_ag_matmul_plain_mesh_sizes(n):
    for shard_dim in (0, 1):
        _ag_case(n, shard_dim, False)
        _ag_case(n, shard_dim, True, M=8)


def test_ag_matmul_plain_bf16():
    _ag_case(4, 0, False, torch.bfloat16)
    _ag_case(4, 1, True, torch.bfloat16)


def test_ag_matmul_plain_uneven_chunks():
    # K = 56 over 8 ranks: 7-wide chunks; M = 3 rows a rank
    _ag_case(8, 0, False, M=3, K=56, N=40)
    _ag_case(8, 1, True, M=3, K=56, N=40)


def _rs_case(n, shard_dim, dtype=torch.float32, M=32, K=48, N=64, seed=1):
    """matmul+reduce-scatter: each rank its own token rows; the n shards
    reassembled against JAX's lax ring and the dense sum."""
    jax, jnp, jfc, mesh_lib, sharding = _jax()
    P = sharding.PartitionSpec
    rng = np.random.RandomState(seed)
    lhs = torch.from_numpy(rng.randn(n * M, K).astype(np.float32) * 0.1) \
        .to(dtype)
    rhs = torch.from_numpy(rng.randn(n * M, N).astype(np.float32) * 0.1) \
        .to(dtype)
    partials = [k.mm_rs_partial(lhs[r * M:(r + 1) * M],
                                rhs[r * M:(r + 1) * M], shard_dim, n)
                for r in range(n)]
    shape = (K // n, N) if shard_dim == 0 else (K, N // n)
    got = torch.cat([k.mm_rs_reduce(partials, r).reshape(shape)
                     for r in range(n)], dim=shard_dim)
    mesh = sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))
    cfg = jfc.CollectiveMatmulConfig(axis_name="data", axis_size=n,
                                     backend="lax", min_shard_bytes=0)

    def f(l, r):
        return jfc.matmul_reduce_scatter(l, r, shard_dim=shard_dim,
                                         axis_name="data", axis_size=n,
                                         cfg=cfg)

    out_spec = P("data", None) if shard_dim == 0 else P(None, "data")
    g = jax.jit(mesh_lib.shard_map(f, mesh=mesh,
                                   in_specs=(P("data", None),
                                             P("data", None)),
                                   out_specs=out_spec, check_vma=False))
    jd = _jdtype(dtype)
    want = np.asarray(g(jnp.asarray(lhs.float().numpy()).astype(jd),
                        jnp.asarray(rhs.float().numpy()).astype(jd)))
    dense = lhs.float().t() @ rhs.float()
    tol = FP32_ATOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=FP32_RTOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=tol,
                               rtol=FP32_RTOL)


@pytest.mark.parametrize("shard_dim", [0, 1])
def test_mm_rs_plain_matches_jax_lax_and_dense(shard_dim):
    _rs_case(4, shard_dim)


def test_mm_rs_plain_mesh_sizes_and_bf16():
    _rs_case(2, 0)
    _rs_case(8, 1)
    _rs_case(4, 0, torch.bfloat16, M=24, K=32, N=16)


def test_mm_rs_reduce_sums_in_the_ring_order():
    """Chunk k's sum starts at rank k+1's partial and ends with rank k's
    own, left to right, as _mm_rs_lax's hops add them."""
    n = 4
    vals = torch.tensor([1.0, 2.0 ** -24, 2.0 ** -24, 2.0 ** -24])
    slots = [torch.full((n, 1), float(v)) for v in vals]
    got = [float(k.mm_rs_reduce(slots, r)) for r in range(n)]
    for r in range(n):
        acc = torch.tensor(float(vals[(r + 1) % n]))
        for j in range(2, n + 1):
            acc = acc + vals[(r + j) % n]
        assert got[r] == float(acc)
    assert got[0] != got[3]         # the order shows in the rounding


@pytest.mark.parametrize("shard_dim", [0, 1])
def test_collective_matmul_vjp_matches_dense(shard_dim):
    """The custom backward's contract, rank by rank: dx = dy @ W^T by the
    transposed all-gather+matmul, dW's shard k the SUM over the ranks by
    matmul+reduce-scatter; against autograd of the dense loss."""
    n, M, K, N = 4, 16, 32, 24
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(n * M, K).astype(np.float32) * 0.1)
    w = torch.from_numpy(rng.randn(K, N).astype(np.float32) * 0.1)
    shards = _shards(w, shard_dim, n)
    xs = [x[r * M:(r + 1) * M] for r in range(n)]
    ys = [k.ag_matmul(xs[r], shards, r, shard_dim) for r in range(n)]
    dys = [2 * y for y in ys]
    dxs = [k.ag_matmul(dys[r], shards, r, shard_dim, transpose_w=True)
           for r in range(n)]
    partials = [k.mm_rs_partial(xs[r], dys[r], shard_dim, n)
                for r in range(n)]
    shape = (K // n, N) if shard_dim == 0 else (K, N // n)
    dw = torch.cat([k.mm_rs_reduce(partials, r).reshape(shape)
                    for r in range(n)], dim=shard_dim)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    loss = ((xr @ wr) ** 2).sum()
    gx, gw = torch.autograd.grad(loss, (xr, wr))
    np.testing.assert_allclose(float(sum((y ** 2).sum() for y in ys)),
                               float(loss.detach()), rtol=1e-5)
    np.testing.assert_allclose(torch.cat(dxs).numpy(), gx.numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(dw.numpy(), gw.numpy(), atol=2e-4,
                               rtol=1e-4)


def test_dispatch_plumbing():
    assert fc.infer_shard_dim((16, 8), 16, 8, 4) is None
    assert fc.infer_shard_dim((4, 8), 16, 8, 4) == 0
    assert fc.infer_shard_dim((16, 2), 16, 8, 4) == 1
    with pytest.raises(ValueError):
        fc.infer_shard_dim((5, 8), 16, 8, 4)
    assert fc.gather_ctx() is None
    c1 = fc.CollectiveMatmulConfig(axis_size=2)
    c2 = fc.CollectiveMatmulConfig(axis_size=4)
    with fc.gather_scope(c1):
        assert fc.gather_ctx() is c1
        with fc.gather_scope(c2):
            assert fc.gather_ctx() is c2
        assert fc.gather_ctx() is c1
    assert fc.gather_ctx() is None
    with pytest.raises(ValueError, match="backend"):
        fc.all_gather_matmul(torch.zeros(4, 8), torch.zeros(4, 4),
                             shard_dim=0, axis_size=2,
                             cfg=fc.CollectiveMatmulConfig(backend="nope"))
    hier = fc.CollectiveMatmulConfig(axis_size=2, hierarchy=(2, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fc.all_gather_matmul(torch.zeros(4, 8), torch.zeros(4, 4),
                             shard_dim=0, axis_size=2, cfg=hier)
    # n == 1: plain products, no world needed
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, 6, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(
        fc.all_gather_matmul(x, w, shard_dim=0, axis_size=1).numpy(),
        (x @ w).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        fc.matmul_reduce_scatter(x, x, shard_dim=0, axis_size=1).numpy(),
        (x.t() @ x).numpy(), atol=1e-6)


def test_collective_dense_is_dense_outside_a_scope_and_with_full_kernels():
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.transformer.transformer import Dense
    gen = torch.Generator().manual_seed(0)
    cd = gpt2.CollectiveDense(16, 24, 0.02, torch.float32, torch.float32,
                              "cpu")
    d = Dense(16, 24, 0.02, torch.float32, torch.float32, "cpu")
    cd.reset_parameters(gen)
    d.load_state_dict(cd.state_dict())
    x = torch.randn(4, 16, generator=gen)
    assert torch.equal(cd(x), d(x))
    with fc.gather_scope(fc.CollectiveMatmulConfig(axis_size=4)):
        assert torch.equal(cd(x), d(x))     # a full kernel: dense


def _box(t, r0, c0, rows, cols):
    """A TMA box: ``rows`` x ``cols`` of the matrix ``t`` from (r0, c0),
    fp32, zeros outside it."""
    out = torch.zeros(rows, cols)
    r1, c1 = min(r0 + rows, t.shape[0]), min(c0 + cols, t.shape[1])
    if r1 > r0 and c1 > c0:
        out[:r1 - r0, :c1 - c0] = t[r0:r1, c0:c1].float()
    return out


def _emulate(plan, load_a, load_b, out_numel):
    """The TMA kernel's walk in torch: every tile's fp32 sum over the k
    steps in the plan's order, written where its epilogue writes (chunk c
    at c * o_chunk, row stride ldo, or row chunks of rc rows r_chunk
    apart; columns inside the chunk only)."""
    out = torch.full((out_numel,), float("nan"))
    n_tiles, k_steps = plan.n_tiles(), plan.k_tiles()
    for i in range(plan.tiles):
        mt, nt = plan.tile(i)
        c, n_map, b_n0, col0, width = n_tiles[nt]
        acc = torch.zeros(plan.bm, plan.bn)
        for _, k_map, a_k0, b_k0 in k_steps:
            owner = n_map if k_map is None else k_map
            acc += load_a(mt * plan.bm, a_k0) @ load_b(owner, b_k0, b_n0)
        rows = torch.arange(mt * plan.bm, min((mt + 1) * plan.bm, plan.M))
        cols = torch.arange(width)
        at = rows * plan.ldo if not plan.rc else \
            rows // plan.rc * plan.r_chunk + rows % plan.rc * plan.ldo
        idx = c * plan.o_chunk + at[:, None] + col0 + cols
        out[idx.reshape(-1)] = acc[:len(rows), :width].reshape(-1)
    return out


def _emulate_ag(x, shards, rank, shard_dim, transpose_w, sms):
    n = len(shards)
    K, N, ck, _, contract, b_col = k.ag_matmul_geometry(
        shards[0].shape, n, shard_dim, transpose_w)
    plan = k.tile_plan("ag", x.shape[0], K, N, ck, n, rank, contract,
                       sms=sms)

    def load_b(owner, b_k0, b_n0):
        if b_col:                   # the shard is [n, k]: a K-major box
            return _box(shards[owner], b_n0, b_k0, plan.bn, plan.bk).t()
        return _box(shards[owner], b_k0, b_n0, plan.bk, plan.bn)
    out = _emulate(plan, lambda m0, k0: _box(x, m0, k0, plan.bm, plan.bk),
                   load_b, x.shape[0] * N)
    return out.reshape(x.shape[0], N)


def _emulate_rs(lhs, rhs, shard_dim, n, sms, slot=None):
    """The partials' walk into n slots ``slot`` elements apart (default:
    back to back): [n, slot] with the slots' tails NaN."""
    M, K = lhs.shape
    N = rhs.shape[1]
    ck = (K if shard_dim == 0 else N) // n
    slot = slot or K * N // n
    plan = k.tile_plan("rs", M, K, N, ck, n, shard_dim=shard_dim, sms=sms,
                       slot=slot)
    out = _emulate(
        plan, lambda m0, k0: _box(lhs, k0, m0, plan.bk, plan.bm).t(),
        lambda owner, b_k0, b_n0: _box(rhs, b_k0, b_n0, plan.bk, plan.bn),
        n * slot)
    return out.reshape(n, slot)


@pytest.mark.parametrize("n,M,K,N", [(2, 9, 144, 200), (4, 5, 72 * 4, 48),
                                     (8, 3, 56, 40)])
@pytest.mark.parametrize("shard_dim", [0, 1])
@pytest.mark.parametrize("transpose_w", [False, True])
def test_tile_plan_walk_matches_plain_and_jax_lax(n, M, K, N, shard_dim,
                                                  transpose_w):
    """Every rank's tile walk against the plain version and JAX's lax ring
    at fp32: chunks of 72 and 100 (BK 64 does not divide them: a ragged
    last k tile zero-filled by its chunk's box) and 7-wide chunks (n 8);
    on 132 SMs (BN 64: several N tiles cut a chunk) and on one (BN up to
    256: one tile wider than its chunk)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(n * M, N if transpose_w else K)
                         .astype(np.float32) * 0.1)
    w = torch.from_numpy(rng.randn(K, N).astype(np.float32) * 0.1)
    shards = _shards(w, shard_dim, n)
    rows = [x[r * M:(r + 1) * M] for r in range(n)]
    for sms in (132, 1):
        got = torch.cat([_emulate_ag(rows[r], shards, r, shard_dim,
                                     transpose_w, sms) for r in range(n)])
        want = torch.cat([k.ag_matmul_plain(rows[r], shards, r, shard_dim,
                                            transpose_w) for r in range(n)])
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FP32_ATOL,
                                   rtol=FP32_RTOL)
    np.testing.assert_allclose(
        got.numpy(), _jax_ag(x, w, n, shard_dim, transpose_w, torch.float32),
        atol=FP32_ATOL, rtol=FP32_RTOL)


@pytest.mark.parametrize("n,M,K,N", [(2, 70, 144, 200), (4, 9, 48, 56 * 4),
                                     (8, 5, 56, 40)])
@pytest.mark.parametrize("shard_dim", [0, 1])
def test_tile_plan_walk_mm_rs_matches_plain_and_jax_lax(n, M, K, N,
                                                        shard_dim):
    """Each rank's matmul+reduce-scatter partials by the tile walk (A =
    lhs^T from lhs's boxes, the slots written chunk by chunk), against
    the plain version; their reduce against JAX's lax ring, at fp32."""
    rng = np.random.RandomState(4)
    lhs = torch.from_numpy(rng.randn(n * M, K).astype(np.float32) * 0.1)
    rhs = torch.from_numpy(rng.randn(n * M, N).astype(np.float32) * 0.1)
    parts = []
    for r in range(n):
        l_r, r_r = lhs[r * M:(r + 1) * M], rhs[r * M:(r + 1) * M]
        for sms in (1, 132):
            got = _emulate_rs(l_r, r_r, shard_dim, n, sms)
            np.testing.assert_allclose(
                got.numpy(), k.mm_rs_partial_plain(l_r, r_r, shard_dim,
                                                   n).numpy(),
                atol=FP32_ATOL, rtol=FP32_RTOL)
        parts.append(got)
    shape = (K // n, N) if shard_dim == 0 else (K, N // n)
    got = torch.cat([k.mm_rs_reduce(parts, r).reshape(shape)
                     for r in range(n)], dim=shard_dim)
    jax, jnp, jfc, mesh_lib, sharding = _jax()
    P = sharding.PartitionSpec
    mesh = sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))
    cfg = jfc.CollectiveMatmulConfig(axis_name="data", axis_size=n,
                                     backend="lax", min_shard_bytes=0)

    def f(a, b):
        return jfc.matmul_reduce_scatter(a, b, shard_dim=shard_dim,
                                         axis_name="data", axis_size=n,
                                         cfg=cfg)
    out_spec = P("data", None) if shard_dim == 0 else P(None, "data")
    g = jax.jit(mesh_lib.shard_map(f, mesh=mesh,
                                   in_specs=(P("data", None),
                                             P("data", None)),
                                   out_specs=out_spec, check_vma=False))
    want = np.asarray(g(jnp.asarray(lhs.numpy()), jnp.asarray(rhs.numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL,
                               rtol=FP32_RTOL)


@pytest.mark.parametrize("n,M,K,N", [(2, 70, 144, 200), (4, 9, 48, 56 * 4)])
@pytest.mark.parametrize("shard_dim", [0, 1])
def test_tile_plan_walk_mm_rs_into_a_layer_region(n, M, K, N, shard_dim):
    """The partials written into a layer's exchange region (the slots a
    region row apart, at a column offset): each slot's columns equal the
    plain version's slot, nothing else in the row is written, and the
    wrapper (the CPU's plain version) fills the same columns."""
    rng = np.random.RandomState(7)
    lhs = torch.from_numpy(rng.randn(M, K).astype(np.float32) * 0.1)
    rhs = torch.from_numpy(rng.randn(M, N).astype(np.float32) * 0.1)
    shard, off = K * N // n, 64
    run = off + shard + 40
    want = k.mm_rs_partial_plain(lhs, rhs, shard_dim, n)
    for sms in (1, 132):
        rows = _emulate_rs(lhs, rhs, shard_dim, n, sms, slot=run)
        np.testing.assert_allclose(rows[:, :shard].numpy(), want.numpy(),
                                   atol=FP32_ATOL, rtol=FP32_RTOL)
        assert torch.isnan(rows[:, shard:]).all()
    region = torch.full((n, run), float("nan"))
    got = k.mm_rs_partial(lhs, rhs, shard_dim, n,
                          out=region[:, off:off + shard])
    assert got.data_ptr() == region[:, off:].data_ptr()
    assert torch.equal(region[:, off:off + shard], want)
    assert torch.isnan(region[:, :off]).all()
    assert torch.isnan(region[:, off + shard:]).all()
    plan = k.tile_plan("rs", M, K, N, (K if shard_dim == 0 else N) // n, n,
                       shard_dim=shard_dim, slot=run)
    assert (plan.o_chunk, plan.rc, plan.r_chunk) == (
        (run, 0, 0) if shard_dim == 1 else (0, K // n, run))
    # what the TMA route needs of the slot distance: 16-byte rows
    bf = torch.bfloat16
    l16, r16 = torch.zeros(8, 64, dtype=bf), torch.zeros(8, 32, dtype=bf)
    wide = torch.zeros(4, 600)
    assert k.mm_rs_partial_route(l16, r16, 0, 4, wide[:, :512]) == \
        "mm_rs_partial"
    odd = torch.zeros(4, 602)
    assert k.mm_rs_partial_route(l16, r16, 0, 4, odd[:, :512]) == \
        "mm_rs_partial_mma"


def test_mm_rs_reduce_writes_each_destination_in_its_dtype():
    """One reduce over [n, run] regions into a table of destinations: each
    takes its columns' ring-order sum in its own dtype (bf16 rounded to
    nearest even, as a cast), the gaps between them are not read (NaN
    there stays out of every result), and the table's order and bounds are
    checked."""
    n, run = 4, 200
    rng = np.random.RandomState(8)
    regions = [torch.from_numpy(rng.randn(n, run).astype(np.float32))
               for _ in range(n)]
    for reg in regions:
        reg[:, 60:64] = float("nan")
    for rank in range(n):
        full = k.mm_rs_reduce_plain([r[:, :60] for r in regions], rank)
        tail = k.mm_rs_reduce_plain([r[:, 64:] for r in regions], rank)
        a = torch.empty(6, 10, dtype=torch.bfloat16)
        b = torch.empty(136)
        got = k.mm_rs_reduce(regions, rank, outs=[(0, a), (64, b)])
        assert got[0][1] is a and got[1][1] is b
        assert torch.equal(a, full.to(torch.bfloat16).view(6, 10))
        assert torch.equal(b, tail)
    bf = torch.empty(8, dtype=torch.bfloat16)
    assert k.mm_rs_reduce(regions, 0, outs=[(10, bf)])[0][1] is bf
    assert torch.equal(
        bf, k.mm_rs_reduce_plain(regions, 0)[10:18].to(torch.bfloat16))


def _deferred_case(how):
    """A resting shard whose dW, inside a layer batch, autograd sums with
    another use of the shard ("summed") or casts ("cast": the backward
    hands back another dtype than the shard's)."""
    from deepspeed_tpu_torch.parallel import overlap
    from deepspeed_tpu_torch.parallel.mesh import Mesh
    class Alone(Mesh):          # every "peer" holds this rank's tensors
        def all_gather(self, t):
            return [t] * self.size

    n, M, K, N = 2, 4, 8, 6
    mesh = Alone(n, 0, "cpu")
    cfg = fc.CollectiveMatmulConfig(axis_size=n, mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, generator=gen)
    w = torch.randn(K // n, N, generator=gen).requires_grad_()
    dy = torch.randn(M, N, generator=gen)

    class WrongDtype(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w_shard):
            return w_shard * 1.0

        @staticmethod
        def backward(ctx, g):
            return fc.matmul_reduce_scatter(
                x, dy, shard_dim=0, axis_size=n, cfg=cfg,
                out_dtype=torch.float64, shard=w)

    sizes = {overlap.shard_key(w): w.numel()}
    with overlap.reduce_scatter_batch(mesh, sizes) as batch:
        if how == "summed":
            y = fc.collective_matmul(x, w, shard_dim=0, axis_size=n,
                                     cfg=cfg)
            loss = (y * dy).sum() + w.sum()
        else:
            loss = WrongDtype.apply(w).sum()
        g, = torch.autograd.grad(loss, [w])
        assert overlap.shard_key(w) in batch.outs
        batch.check_returned({overlap.shard_key(w): g})


@pytest.mark.parametrize("how", ["summed", "cast"])
def test_a_deferred_output_that_autograd_summed_or_cast_raises(how):
    """Inside a layer batch dW comes back unfilled until the batch closes;
    autograd summing it with another gradient, or casting it, reads it
    unfilled. The check after autograd returns sees that the returned
    gradient is not the deferred tensor and raises (and the batch never
    closes, so no exchange starts)."""
    with pytest.raises(RuntimeError, match="summed or cast"):
        _deferred_case(how)


def test_matmul_reduce_scatter_in_a_batch_needs_its_shard_and_an_entry():
    from deepspeed_tpu_torch.parallel import overlap
    from deepspeed_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(2, 0, "cpu")
    cfg = fc.CollectiveMatmulConfig(axis_size=2, mesh=mesh)
    x, dy = torch.zeros(4, 8), torch.zeros(4, 6)
    w = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="resting shard"):
        with overlap.reduce_scatter_batch(mesh, {}):
            fc.matmul_reduce_scatter(x, dy, shard_dim=0, axis_size=2,
                                     cfg=cfg)
    with pytest.raises(KeyError, match="names every leaf"):
        with overlap.reduce_scatter_batch(mesh, {("group", 0): 8}):
            fc.matmul_reduce_scatter(x, dy, shard_dim=0, axis_size=2,
                                     cfg=cfg, shard=w)
    # the layout: entries at multiples of 64 elements, in order
    b = overlap.ReduceScatterBatch(mesh, {"a": 3, "b": 64, "c": 65})
    assert b.entries == {"a": (0, 3), "b": (64, 64), "c": (128, 65)}
    assert b.run == 256 == overlap.batch_run([3, 64, 65])
    assert tuple(b.columns("b").shape) == (2, 64)
    assert b.columns("b").stride() == (256, 1)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_tile_plan_ring_order_and_chunk_aligned_n_tiles(n):
    """Contracting shards: the k tiles run chunk by chunk from the rank's
    own, (rank - s) mod n, each chunk's tiles in order and read from its
    owner's map. Column-cut shards (and mm_rs's slots under shard dim 1):
    every N tile lies inside one chunk and reads its owner's map."""
    ck = 200                                    # 4 k tiles, the last ragged
    for rank in range(n):
        plan = k.tile_plan("ag", 256, n * ck, 384, ck, n, rank, True)
        steps = plan.k_tiles()
        assert len(steps) == n * 4
        for t, (kc, owner, a_k0, b_k0) in enumerate(steps):
            assert kc == owner == (rank - t // 4) % n
            assert b_k0 == (t % 4) * 64 and a_k0 == kc * ck + b_k0
        assert [c for c, *_ in plan.n_tiles()] == [0] * plan.nt_chunk
    for kind, args in (("ag", dict(contract=False)),
                       ("rs", dict(shard_dim=1))):
        for sms in (132, 1):             # BN 64 and 256
            plan = k.tile_plan(kind, 256, 512, n * 200, 200, n, sms=sms,
                               **args)
            assert plan.bn == (64 if sms > 1 else 256)
            tiles = plan.n_tiles()
            assert len(tiles) == n * plan.nt_chunk
            covered = {c: [] for c in range(n)}
            for c, owner, b_n0, col0, width in tiles:
                assert 0 < width <= plan.bn and col0 + width <= plan.cw
                if kind == "ag":
                    assert owner == c and b_n0 == col0
                else:
                    assert owner == 0 and b_n0 == c * plan.cw + col0
                covered[c] += range(col0, col0 + width)
            assert all(v == list(range(200)) for v in covered.values())
            assert all(owner is None for _, owner, _, _ in plan.k_tiles())


def test_tile_plan_picks_bn_by_waves_on_the_main_path():
    """GPT-2 large's leaves at M 2048 over 4 shards on 132 SMs: the BN
    each takes, and the tiles and grid it launches."""
    want = {("ag", "c_attn", False): (256, 256), ("ag", "c_attn", True):
            (192, 112), ("ag", "attn.c_proj", False): (192, 112),
            ("ag", "attn.c_proj", True): (192, 128),
            ("ag", "c_fc", False): (128, 640), ("ag", "c_fc", True):
            (192, 112), ("ag", "mlp.c_proj", False): (192, 112),
            ("ag", "mlp.c_proj", True): (128, 640),
            ("rs", "c_attn", None): (192, 200),
            ("rs", "attn.c_proj", None): (128, 100),
            ("rs", "c_fc", None): (256, 200),
            ("rs", "mlp.c_proj", None): (256, 200)}
    leaves = (("c_attn", 1280, 3840, 1), ("attn.c_proj", 1280, 1280, 0),
              ("c_fc", 1280, 5120, 1), ("mlp.c_proj", 5120, 1280, 0))
    for leaf, din, dout, d in leaves:
        shard = (din // 4, dout) if d == 0 else (din, dout // 4)
        for tr in (False, True):
            K, N, ck, _, contract, _ = k.ag_matmul_geometry(shard, 4, d, tr)
            plan = k.tile_plan("ag", 2048, K, N, ck, 4, 1, contract)
            assert (plan.bn, plan.tiles) == want[("ag", leaf, tr)]
            assert plan.grid == min(plan.tiles, 132)
        plan = k.tile_plan("rs", 2048, din, dout,
                           (din if d == 0 else dout) // 4, 4, shard_dim=d)
        assert (plan.bn, plan.tiles) == want[("rs", leaf, None)]


def test_route_aligned_to_tma_else_to_mma():
    """The shape test: widths and chunks that are multiples of 8 with
    16-byte aligned bases take the TMA kernel; a 7-wide chunk or a base
    off 16 bytes takes the mma.sync kernel, under its own launch name."""
    bf = torch.bfloat16
    x, w = torch.zeros(16, 64, dtype=bf), torch.zeros(64, 32, dtype=bf)
    for d in (0, 1):
        for tr in (False, True):
            shards = _shards(w.t().contiguous() if tr else w, d, 4)
            shards = [s.contiguous() for s in shards]
            xx = torch.zeros(16, 32, dtype=bf) if tr else x
            assert k.ag_matmul_route(xx, shards, d, tr) == "ag_matmul"
    seven = [torch.zeros(7, 32, dtype=bf) for _ in range(4)]
    assert k.ag_matmul_route(torch.zeros(5, 28, dtype=bf), seven, 0) == \
        "ag_matmul_mma"
    buf = torch.zeros(16 * 64 + 1, dtype=bf)
    off = buf[1:].view(16, 64)                 # 2 bytes past an aligned base
    assert k.ag_matmul_route(off, [s.contiguous() for s in
                                   _shards(w, 0, 4)], 0) == "ag_matmul_mma"
    lhs, rhs = torch.zeros(8, 64, dtype=bf), torch.zeros(8, 32, dtype=bf)
    assert k.mm_rs_partial_route(lhs, rhs, 0, 4) == "mm_rs_partial"
    assert k.mm_rs_partial_route(lhs, rhs, 1, 4) == "mm_rs_partial"
    assert k.mm_rs_partial_route(torch.zeros(8, 56, dtype=bf), rhs, 0, 8) \
        == "mm_rs_partial_mma"
    slots = torch.zeros(4 * 64 * 32 + 2, dtype=torch.float32)[2:]
    assert k.mm_rs_partial_route(lhs, rhs, 0, 4, slots) == \
        "mm_rs_partial_mma"
    # the CPU takes the plain version on either name
    w8 = torch.from_numpy(np.random.RandomState(5).randn(56, 40)
                          .astype(np.float32))
    x8 = torch.from_numpy(np.random.RandomState(6).randn(3, 56)
                          .astype(np.float32))
    sh = _shards(w8, 0, 8)
    assert torch.equal(k.ag_matmul_mma(x8, sh, 2, 0),
                       k.ag_matmul_plain(x8, sh, 2, 0))
    assert torch.equal(k.mm_rs_partial_mma(x8, x8, 0, 8),
                       k.mm_rs_partial_plain(x8, x8, 0, 8))


@pytest.mark.gpu
def test_kernels_over_a_two_rank_heap_match_plain(cuda_device):  # noqa: F811
    """Two ranks on the card share a symmetric heap: every ag_matmul
    variant over the peers' shard views and mm_rs_partial + mm_rs_reduce
    over the peers' slots, each against its plain version."""
    import torch_zero3_worker as w
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.parallel.mesh import spawn
    builder.kernels()                 # build once before the ranks start
    for rank_errs in spawn(w.heap_kernels, 2):
        for name, (err, limit) in rank_errs.items():
            assert err <= limit, (name, err, limit)


@pytest.mark.gpu
def test_layer_batch_over_a_two_rank_heap_matches_plain(cuda_device):  # noqa: F811
    """Two ranks on the card close one layer batch (streamed leaves' bf16
    dW by both partial kernels, a packed group's fp32 flat): one
    mm_rs_reduce launch writes every entry bit for bit as
    mm_rs_reduce_plain over the same regions, cast to the entry's dtype."""
    import torch_zero3_worker as w
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.parallel.mesh import spawn
    builder.kernels()                 # build once before the ranks start
    for errs, launched in spawn(w.heap_layer_batch, 2):
        assert launched == {"mm_rs_reduce": 1}, launched
        for name, (equal, dtype) in errs.items():
            assert equal, (name, dtype)
