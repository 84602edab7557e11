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
held against dense autograd. On the card, two ranks share a symmetric
heap and each kernel is held against its plain version. JAX is imported
inside the tests, so the gpu test runs where JAX is not installed.
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
