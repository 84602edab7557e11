"""deepspeed_tpu_torch's host libraries and swappers vs the JAX package's.

The native SIMD Adam (``ops/native/cpu_adam.py``, built by the port from
its own copy of ``csrc/cpu_adam.cpp``) against the JAX package's build of
the same source, bit for bit on seeded numpy inputs; the async I/O
handle's round trips on both backends, many small requests, a split
large transfer and its error count; the contiguous arena (mirroring
tests/test_contiguous_allocator.py); the swappers' round trips, and the
size check that rejects a truncated swap file. On the card (``gpu``):
the streamed tier against the device optimizer bit for bit, and the host
runner's pinned, stream-ordered step against its CPU run bit for bit
(``python -m pytest --noconftest -m gpu tests/test_torch_swap.py``; the
JAX package is imported inside the tests that use it, so this file also
runs where JAX is not installed).
"""

import importlib
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.native import aio
from deepspeed_tpu_torch.ops.native import cpu_adam
from deepspeed_tpu_torch.runtime.swap_tensor.swapper import (
    OptimizerStateSwapper, PartitionedParamSwapper, TensorSwapper)
from deepspeed_tpu_torch.runtime.zero.contiguous_memory_allocator import \
    ContiguousMemoryAllocator
from torch_port_common import cuda_device  # noqa: F401

N = 4099          # not a multiple of any SIMD width


def _rand(seed, n=N, scale=1.0):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(a.copy())


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _jax_native():
    """The JAX package's build of csrc/cpu_adam.cpp (imported here, not at
    the top, so the gpu tests run where JAX is not installed)."""
    return importlib.import_module("deepspeed_tpu.ops.native.cpu_adam").load()


# -- the native Adam ----------------------------------------------------------

@pytest.mark.parametrize("adamw,wd,bias", [(True, 0.01, True),
                                           (False, 0.1, True),
                                           (True, 0.0, False)])
def test_adam_step_bit_equal_to_jax_build(adamw, wd, bias):
    lib, jlib = cpu_adam.load(), _jax_native()
    p, g = _rand(0), _rand(1)
    jp, jm, jv = p.copy(), np.zeros(N, np.float32), np.zeros(N, np.float32)
    tp, tm, tv = _t(p), torch.zeros(N), torch.zeros(N)
    for step in range(1, 4):
        jlib.adam_step(jp, g, jm, jv, step, 1e-2, 0.9, 0.999, 1e-8, wd,
                       adamw, bias)
        lib.adam_step(tp, _t(g), tm, tv, step, 1e-2, 0.9, 0.999, 1e-8, wd,
                      adamw, bias)
    for a, b in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


def test_adam_step_multi_bit_equal_to_jax_build():
    lib, jlib = cpu_adam.load(), _jax_native()
    sizes = (7, 1024, 333)
    ps = [_rand(10 + i, n) for i, n in enumerate(sizes)]
    gs = [_rand(20 + i, n) for i, n in enumerate(sizes)]
    jm = [np.zeros(n, np.float32) for n in sizes]
    jv = [np.zeros(n, np.float32) for n in sizes]
    jp = [p.copy() for p in ps]
    tp, tm, tv = [_t(p) for p in ps], [torch.zeros(n) for n in sizes], \
        [torch.zeros(n) for n in sizes]
    for step in (1, 2):
        jlib.adam_step_multi(jp, gs, jm, jv, step, 3e-3, 0.9, 0.99, 1e-8,
                             0.01, True)
        lib.adam_step_multi(tp, [_t(g) for g in gs], tm, tv, step, 3e-3,
                            0.9, 0.99, 1e-8, 0.01, True)
    for a, b in zip(tp + tm + tv, jp + jm + jv):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


@pytest.mark.parametrize("bf16_grads", [False, True])
@pytest.mark.parametrize("grad_scale", [1.0, 0.37])
def test_adam_step_ex_bit_equal_to_jax_build(bf16_grads, grad_scale):
    """grad_scale folded into the read, bf16 or fp32 gradients, and the
    bf16 copy of the updated parameters written in the same pass."""
    import ml_dtypes
    lib, jlib = cpu_adam.load(), _jax_native()
    p, g = _rand(2), _rand(3, scale=4.0)
    jm, jv = np.full(N, 0.1, np.float32), np.full(N, 0.2, np.float32)
    tm, tv = _t(jm), _t(jv)
    jp, tp = p.copy(), _t(p)
    if bf16_grads:
        jg = g.astype(ml_dtypes.bfloat16)
        tg = torch.from_numpy(jg.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        jg, tg = g, _t(g)
    jout = np.empty(N, np.uint16)
    tout = torch.empty(N, dtype=torch.bfloat16)
    jlib.adam_step_ex(jp, jg, jm, jv, 5, 1e-3, 0.9, 0.999, 1e-8, 0.01, True,
                      grad_scale=grad_scale, params_bf16=jout)
    lib.adam_step_ex(tp, tg, tm, tv, 5, 1e-3, 0.9, 0.999, 1e-8, 0.01, True,
                     grad_scale=grad_scale, params_bf16=tout)
    for a, b in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    np.testing.assert_array_equal(tout.view(torch.int16).numpy()
                                  .view(np.uint16), jout)
    assert torch.equal(tout, tp.to(torch.bfloat16))


def test_lamb_steps_bit_equal_to_jax_build():
    lib, jlib = cpu_adam.load(), _jax_native()
    p, g = _rand(4), _rand(5)
    outs = []
    for kind in ("plain", "ex"):
        jp, jm, jv = p.copy(), np.zeros(N, np.float32), \
            np.zeros(N, np.float32)
        tp, tm, tv = _t(p), torch.zeros(N), torch.zeros(N)
        args = (2, 1e-2, 0.9, 0.999, 1e-6, 0.01, 10.0, 0.01)
        if kind == "plain":
            jlib.lamb_step(jp, g, jm, jv, *args)
            lib.lamb_step(tp, _t(g), tm, tv, *args)
        else:
            jlib.lamb_step_ex(jp, g, jm, jv, *args, grad_scale=0.5)
            lib.lamb_step_ex(tp, _t(g), tm, tv, *args, grad_scale=0.5)
        for a, b in ((tp, jp), (tm, jm), (tv, jv)):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        outs.append(tp)
    assert not torch.equal(outs[0], outs[1])      # the scale took effect


def test_bf16_converters_and_l2_norm_bit_equal_to_jax_build():
    lib, jlib = cpu_adam.load(), _jax_native()
    x = _rand(6, scale=1e3)
    x[:4] = [np.inf, -np.inf, np.nan, 0.0]
    jb = jlib.fp32_to_bf16(x)
    tb = lib.fp32_to_bf16(_t(x))
    np.testing.assert_array_equal(tb.view(torch.int16).numpy()
                                  .view(np.uint16), jb)
    np.testing.assert_array_equal(_bits(lib.bf16_to_fp32(tb).numpy()),
                                  _bits(jlib.bf16_to_fp32(jb)))
    # an OpenMP reduction in fp64: the threads' partial sums combine in
    # no fixed order, so two runs of one build may part in the last bit
    y = _rand(7)
    assert lib.l2_norm(_t(y)) == pytest.approx(jlib.l2_norm(y), rel=1e-13)
    assert lib.l2_norm(_t(y)) == pytest.approx(
        float(np.sqrt(np.sum(y.astype(np.float64) ** 2))), rel=1e-13)
    assert lib.num_threads() >= 1


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_host_runner_step_bit_equal_to_jax_runner(tier, tmp_path):
    """HostOffloadOptimizer.step_streamed on fp32 host gradients, writing
    fp32 host parameters (the host tier's moments in memory; the NVMe
    tier's read ahead and stored back leaf by leaf), against the JAX
    runner's step on the same numpy leaves: masters, moments and the
    written parameters bit for bit."""
    jcfg_mod = importlib.import_module("deepspeed_tpu.config.config")
    JOffload = importlib.import_module(
        "deepspeed_tpu.runtime.zero.offload").HostOffloadOptimizer
    JAdam = importlib.import_module("deepspeed_tpu.ops.adam").FusedAdam
    from deepspeed_tpu_torch.config.config import ZeroOffloadConfig
    from deepspeed_tpu_torch.ops.adam import FusedAdam
    from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
    shapes = [(16, 8), (33,), (4, 4, 3)]
    rs = np.random.RandomState(0)
    leaves = {f"w{i}": rs.randn(*s).astype(np.float32)
              for i, s in enumerate(shapes)}
    block = {"device": tier}
    if tier == "nvme":
        (tmp_path / "j").mkdir()
        (tmp_path / "t").mkdir()
    jrun = JOffload(leaves, JAdam(lr=1e-2, weight_decay=0.01),
                    jcfg_mod.ZeroOffloadConfig(
                        dict(block, nvme_path=str(tmp_path / "j"))))
    trun = HostOffloadOptimizer(
        [_t(leaves[k]) for k in sorted(leaves)],
        FusedAdam(lr=1e-2, weight_decay=0.01),
        ZeroOffloadConfig(dict(block, nvme_path=str(tmp_path / "t"))))
    params = [torch.zeros(leaves[k].shape) for k in sorted(leaves)]
    for step in range(3):
        grads = [rs.randn(*leaves[k].shape).astype(np.float32)
                 for k in sorted(leaves)]
        jmaster = jrun.step(grads, 3e-3)
        trun.step_streamed([_t(g) for g in grads], 3e-3, params=params)
    jsd, tsd = jrun.state_dict(), trun.state_dict()
    for i, k in enumerate(sorted(leaves)):
        np.testing.assert_array_equal(_bits(trun.master[i].numpy()),
                                      _bits(jmaster[i]))
        np.testing.assert_array_equal(_bits(params[i].numpy()),
                                      _bits(jmaster[i]))
        for field in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(
                _bits(tsd[field][i].numpy()),
                _bits(np.asarray(jsd[field][k])))
    assert trun.step_count == jrun.step_count == 3
    trun.close()


def test_native_refuses_wrong_buffers():
    lib = cpu_adam.load()
    p = torch.zeros(8)
    with pytest.raises(TypeError, match="contiguous CPU"):
        lib.adam_step(p, torch.zeros(16)[::2], p.clone(), p.clone(), 1, 1e-3,
                      0.9, 0.999, 1e-8, 0.0, True)
    with pytest.raises(ValueError, match="sizes differ"):
        lib.adam_step(p, torch.zeros(9), p.clone(), p.clone(), 1, 1e-3, 0.9,
                      0.999, 1e-8, 0.0, True)
    with pytest.raises(TypeError):
        lib.adam_step_ex(p, torch.zeros(8, dtype=torch.float16), p.clone(),
                         p.clone(), 1, 1e-3, 0.9, 0.999, 1e-8, 0.0, True)


def test_cpuadam_optimizer_steps_on_the_host():
    """The ``cpuadam`` type, stepped by the host runner, against the JAX
    class's own host step on the same leaf: bit for bit."""
    JCPUAdam = importlib.import_module(
        "deepspeed_tpu.ops.adam").DeepSpeedCPUAdam
    from deepspeed_tpu_torch.config.config import ZeroOffloadConfig
    from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam
    from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
    opt = DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.01)
    jopt = JCPUAdam(lr=1e-2, weight_decay=0.01)
    p, g = _rand(8), _rand(9)
    jp, jm, jv = p.copy(), np.zeros(N, np.float32), np.zeros(N, np.float32)
    run = HostOffloadOptimizer([_t(p)], opt, ZeroOffloadConfig(
        {"device": "cpu", "stream": "host"}))
    out = [torch.zeros(N)]
    for step in (1, 2):
        jopt.step_numpy(jp, g, jm, jv, step, 1e-2)
        run.step_streamed([_t(g)], 1e-2, params=out)
    np.testing.assert_array_equal(_bits(run.master[0].numpy()), _bits(jp))
    np.testing.assert_array_equal(_bits(out[0].numpy()), _bits(jp))
    run.close()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    from deepspeed_tpu_torch.ops.native import builder
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    b = builder.OpBuilder("broken", str(bad))
    monkeypatch.setattr(builder, "CSRC", str(tmp_path))
    with pytest.raises(RuntimeError, match="failed to build broken"):
        b.load()


# -- async I/O ----------------------------------------------------------------

def test_aio_roundtrip(tmp_path):
    h = aio.AsyncIOHandle(block_size=4096, thread_count=2)
    data = torch.from_numpy(_rand(0, 32768))
    path = str(tmp_path / "t.bin")
    h.sync_pwrite(data, path)
    out = torch.empty_like(data)
    h.sync_pread(out, path)
    assert torch.equal(data, out)


@pytest.mark.parametrize("backend", ["threads", "io_uring", "auto"])
def test_aio_backends_roundtrip(tmp_path, backend):
    try:
        h = aio.AsyncIOHandle(block_size=8192, queue_depth=8, thread_count=2,
                              backend=backend)
    except OSError:
        assert backend == "io_uring"
        # the refusal is the io_uring backend's contract where the kernel
        # or its seccomp profile has no io_uring; auto then takes threads
        assert aio.AsyncIOHandle(backend="auto").backend == "threads"
        return
    assert h.backend in ("threads", "io_uring")
    if backend != "auto":
        assert h.backend == backend
    data = torch.from_numpy(_rand(2, 100000))
    path = str(tmp_path / "t.bin")
    fd = h.open(path, True)
    h.async_pwrite(data, fd)
    assert h.wait() == 1
    h.close(fd)
    out = torch.empty_like(data)
    fd = h.open(path, False)
    h.async_pread(out, fd)
    assert h.wait() == 1
    h.close(fd)
    assert torch.equal(data, out)


def test_aio_many_small_requests(tmp_path):
    h = aio.AsyncIOHandle(block_size=1024, queue_depth=4, thread_count=2)
    chunks = [torch.from_numpy(_rand(3 + i, 1000 + i)) for i in range(32)]
    path = str(tmp_path / "many.bin")
    fd = h.open(path, True)
    off = 0
    for c in chunks:
        h.async_pwrite(c, fd, offset=off)
        off += c.numel() * 4
    assert h.wait() == len(chunks)
    h.close(fd)
    outs = [torch.empty_like(c) for c in chunks]
    fd = h.open(path, False)
    off = 0
    for o in outs:
        h.async_pread(o, fd, offset=off)
        off += o.numel() * 4
    assert h.wait() == len(chunks)
    h.close(fd)
    for c, o in zip(chunks, outs):
        assert torch.equal(c, o)


def test_aio_split_large_transfer_roundtrip_and_one_error(tmp_path):
    """A large transfer fans across the worker pool and round-trips bit
    for bit; one failed user request counts one error, however many
    pieces it was split into."""
    h = aio.AsyncIOHandle(block_size=4096, queue_depth=4, thread_count=4)
    data = torch.from_numpy(_rand(5, 1 << 18))
    path = str(tmp_path / "big.swp")
    h.sync_pwrite(data, path)
    out = torch.empty_like(data)
    fd = h.open(path, False)
    h.async_pread(out, fd)
    h.wait()
    h.close(fd)
    assert torch.equal(out, data)
    short = tmp_path / "short.bin"
    short.write_bytes(b"\0" * 4096)
    buf = torch.zeros(1 << 20, dtype=torch.uint8)
    fd = h.open(str(short), False)
    h.async_pread(buf, fd, 0)
    with pytest.raises(IOError, match=r"\b1 async IO request"):
        h.wait()
    h.close(fd)
    h.sync_pread(out, path)          # the handle recovered
    assert torch.equal(out, data)


def test_aio_o_direct_layer_roundtrips_unaligned_tails(tmp_path):
    """O_DIRECT mode: an aligned body submits zero-copy, an unaligned
    tail or buffer bounces, and the bytes round-trip; on a filesystem
    that refuses O_DIRECT the handle latches to buffered I/O."""
    aio.reset_o_direct_fallback_for_tests()
    try:
        h = aio.AsyncIOHandle(block_size=8192, thread_count=2, o_direct=True)
        body = aio.aligned_empty(3 * 4096 + 100)
        body.copy_(torch.randint(0, 255, (body.numel(),), dtype=torch.uint8))
        path = str(tmp_path / "d.swp")
        h.sync_pwrite(body, path)
        back = aio.aligned_empty(body.numel())
        h.sync_pread(back, path)
        assert torch.equal(back, body)
        if h.direct_active:
            assert h.stats["direct_tail_bounced"] >= 1
            assert os.path.getsize(path) == aio.align_up(body.numel())
        else:
            assert aio.o_direct_fallback_latched()
    finally:
        aio.reset_o_direct_fallback_for_tests()


# -- the arena ----------------------------------------------------------------

def test_alloc_and_release_roundtrip():
    a = ContiguousMemoryAllocator(100)
    t1, v1 = a.allocate_tensor(40)
    t2, v2 = a.allocate_tensor(40)
    assert a.total_free == 20
    v1[:] = 1.0
    v2[:] = 2.0
    a.release_tensor(t1)
    assert a.total_free == 60
    assert torch.equal(a.get_tensor(t2), torch.full((40,), 2.0))


def test_free_block_merging():
    a = ContiguousMemoryAllocator(100)
    t1, _ = a.allocate_tensor(30)
    t2, _ = a.allocate_tensor(30)
    t3, _ = a.allocate_tensor(30)
    a.release_tensor(t1)
    a.release_tensor(t3)
    a.release_tensor(t2)
    assert a.free_blocks == {0: 100}


def test_defragment_preserves_contents():
    a = ContiguousMemoryAllocator(100)
    ids = []
    for i in range(5):
        tid, v = a.allocate_tensor(20)
        v[:] = float(i)
        ids.append(tid)
    a.release_tensor(ids[1])
    a.release_tensor(ids[3])
    assert a._largest_free() == 20
    tid, v = a.allocate_tensor(40)
    v[:] = 9.0
    for i in (0, 2, 4):
        assert torch.equal(a.get_tensor(ids[i]), torch.full((20,), float(i)))
    assert torch.equal(a.get_tensor(tid), torch.full((40,), 9.0))
    assert a.total_free == 0


def test_exhaustion_raises():
    a = ContiguousMemoryAllocator(10)
    a.allocate_tensor(8)
    with pytest.raises(MemoryError, match="arena exhausted"):
        a.allocate_tensor(4)


def test_views_alias_arena_and_aligned_arena():
    a = ContiguousMemoryAllocator(16)
    tid, v = a.allocate_tensor(16)
    v[:] = 7.0
    assert a.buffer[0] == 7.0
    b = ContiguousMemoryAllocator(3000, align_elems=1024)
    assert b.buffer.data_ptr() % 4096 == 0
    _, x = b.allocate_tensor(5)
    _, y = b.allocate_tensor(5)
    assert (y.data_ptr() - x.data_ptr()) == 4096


# -- the swappers -------------------------------------------------------------

def test_tensor_swapper_roundtrip_and_prefetch(tmp_path):
    sw = TensorSwapper(str(tmp_path))
    x = torch.from_numpy(_rand(1, 4096))
    sw.swap_out("a", x)
    out = torch.empty_like(x)
    sw.swap_in("a", out)
    assert torch.equal(x, out)
    buf = torch.empty_like(x)
    sw.prefetch("a", buf)
    assert torch.equal(sw.swap_in("a", buf), x)
    d = sw.dir
    sw.release()
    assert not os.path.exists(d)


def test_tensor_swapper_prefetch_error_attribution(tmp_path):
    sw = TensorSwapper(str(tmp_path))
    a = torch.arange(64, dtype=torch.float32)
    sw.swap_out("good", a)
    with open(sw._path("bad"), "wb") as f:
        f.write(b"xyz")
    out = torch.zeros_like(a)
    sw.prefetch("bad", out)
    with pytest.raises(IOError):
        sw.swap_out("good", a)
    sw.swap_in("good", out)
    assert torch.equal(out, a)
    sw.release()


@pytest.mark.parametrize("pipeline_write", [False, True])
def test_optimizer_swapper_roundtrip_over_the_arena(tmp_path, pipeline_write):
    sw = OptimizerStateSwapper(str(tmp_path), pipeline_write=pipeline_write)
    shapes = {0: (8, 8), 1: (3, 5)}
    for leaf, shape in shapes.items():
        sw.init_state(leaf, shape)
    sw.prefetch(0)
    for _ in range(4):
        for leaf in (0, 1):
            m, v = sw.fetch(leaf)
            sw.prefetch((leaf + 1) % 2)
            m += 1.0
            v += 2.0
            sw.store(leaf, m, v)
    sw.drain_writes()
    for leaf, shape in shapes.items():
        m, v = sw.fetch(leaf)
        assert torch.equal(m, torch.full(shape, 4.0))
        assert torch.equal(v, torch.full(shape, 8.0))
    arena = sw._arena.arena
    assert arena is not None and arena.max_allocated <= arena.size
    assert sw.registry.counter("swap/bytes_written").value > 0
    sw.release()


@pytest.mark.parametrize("pipeline_write", [False, True])
def test_param_swapper_roundtrip_cache_and_order(tmp_path, pipeline_write):
    sw = PartitionedParamSwapper(str(tmp_path), pipeline_read=True,
                                 pipeline_write=pipeline_write,
                                 buffer_count=2)
    rs = np.random.RandomState(0)
    leaves = [torch.from_numpy(rs.randn(*s).astype(np.float32))
              .to(torch.bfloat16) for s in ((4, 6), (7,), (3, 3), (5, 2))]
    sw.swap_out_device(leaves)
    got = sw.swap_in_device("cpu", order=[2, 0, 3, 1])
    for a, b in zip(got, leaves):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    if pipeline_write:
        assert sw.registry.counter("swap/cache_hit_bytes").value > 0
    sw.write_all(leaves[::-1])
    for a, b in zip(sw.swap_in_device("cpu"), leaves[::-1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="permutation"):
        sw.swap_in_device("cpu", order=[0, 0, 1, 2])
    sw.release()
    assert not os.path.exists(sw.dir)


def test_param_swapper_meta_rejects_a_truncated_file(tmp_path):
    """A durable tier's metadata is checked against its files: a file cut
    short (a crash mid-write) raises instead of restoring wrong bytes."""
    leaves = [torch.arange(12, dtype=torch.float32).view(3, 4),
              torch.ones(5, dtype=torch.bfloat16)]
    sw = PartitionedParamSwapper(str(tmp_path), sub_dir="infinity",
                                 durable=True)
    sw.write_all(leaves)
    sw.release()
    fresh = PartitionedParamSwapper(str(tmp_path), sub_dir="infinity",
                                    durable=True)
    meta = fresh.load_meta()
    assert meta == {0: ((3, 4), torch.float32), 1: ((5,), torch.bfloat16)}
    for a, b in zip(fresh.swap_in_device("cpu"), leaves):
        assert torch.equal(a, b)
    with open(fresh._path(0), "r+b") as f:
        f.truncate(40)
    with pytest.raises(ValueError, match="truncated or stale"):
        fresh.load_meta()
    with open(fresh._path(0), "wb") as f:
        f.write(leaves[0].numpy().tobytes())
    assert fresh.load_meta() == meta
    os.remove(fresh._path(1))
    with pytest.raises(ValueError, match="missing"):
        PartitionedParamSwapper(str(tmp_path), sub_dir="infinity",
                                durable=True).load_meta()


# -- on the card --------------------------------------------------------------

def _leaves(shapes, seed, device, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
        device, dtype) for s in shapes]


@pytest.mark.gpu
def test_streamed_tier_on_the_card_matches_the_device_optimizer(cuda_device):
    """The state in pinned host arenas, groups of units (leaves cut along
    dim 0) through two device slots on three streams: every master,
    moment and compute-copy bit equals FusedAdam's step on the card."""
    from deepspeed_tpu_torch.ops.adam import FusedAdam
    from deepspeed_tpu_torch.runtime.zero.offload_stream import \
        StreamedOffloadOptimizer
    opt = FusedAdam(lr=1e-2, weight_decay=0.1, moment_dtype="bf16")
    shapes = [(37, 8), (5,), (64, 3), (1, 9), (300, 7), (11,)]
    masters = _leaves(shapes, 0, cuda_device)
    grads = [_leaves(shapes, 1 + k, cuda_device, torch.bfloat16)
             for k in range(3)]
    lr, scale = torch.tensor(3e-3, device=cuda_device), \
        torch.tensor(0.5, device=cuda_device)
    ref = [m.clone() for m in masters]
    state = opt.init(ref)
    run = StreamedOffloadOptimizer(masters, opt, cuda_device, unit_bytes=512)
    assert run._master.is_pinned() and run._m.tensor.is_pinned()
    assert len(run.groups) > 2 and any(u.split for u in run.units)
    params = [m.to(torch.bfloat16) for m in masters]
    for g in grads:
        opt.step(ref, [x.clone() for x in g], state, lr, grad_scale=scale)
        run.step([x.clone() for x in g], params, lr, grad_scale=scale)
    torch.cuda.synchronize()
    for a, b in zip(run.master_leaves(), ref):
        assert torch.equal(a, b.cpu())
    sd = run.state_dict()
    for k in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(sd[k], state[k]):
            assert torch.equal(a, b.float().cpu())
    for p, r in zip(params, ref):
        assert torch.equal(p, r.to(torch.bfloat16))
    run.close()


@pytest.mark.gpu
def test_host_runner_on_the_card_matches_its_cpu_run(cuda_device):
    """Gradients copied to pinned slots on a side stream, the native step
    as each lands, the bf16 leaves pushed back on another stream, over
    more leaves than slots: bit for bit the runner's CPU run."""
    from deepspeed_tpu_torch.config.config import ZeroOffloadConfig
    from deepspeed_tpu_torch.ops.adam import FusedAdam
    from deepspeed_tpu_torch.runtime.zero import offload
    opt = FusedAdam(lr=1e-2, weight_decay=0.1)
    cfg = ZeroOffloadConfig({"device": "cpu", "stream": "host"})
    shapes = [(64, 32), (5,), (3, 9), (128,), (17, 3), (2, 2), (40, 40)]
    assert len(shapes) > offload.SLOTS
    outs = []
    for dev in ("cpu", cuda_device):
        masters = _leaves(shapes, 0, dev)
        run = offload.HostOffloadOptimizer(masters, opt, cfg, device=dev)
        params = [m.to(torch.bfloat16) for m in masters]
        for k in range(3):
            run.step_streamed(_leaves(shapes, 1 + k, dev, torch.bfloat16),
                              3e-3, grad_scale=0.5, params=params)
        outs.append(([p.cpu() for p in params], run.master_leaves()))
    for a, b in zip(outs[0][0] + outs[0][1], outs[1][0] + outs[1][1]):
        assert torch.equal(a, b)
