"""Rank bodies for the n-rank ZeRO-3 tests (tests/test_torch_zero3.py,
tests/test_torch_fused_collective.py). They run in processes started by
``deepspeed_tpu_torch.parallel.mesh.spawn`` and import nothing of JAX."""

import torch


def train_modes(rank, world, cfgs, state, batches):
    """For each (mode, ds_config) in ``cfgs``: the tiny GPT-2 from the
    ``state`` dict (numpy), ``train_batch`` over ``batches``; returns
    {mode: (losses, gathered fp32 params by name (rank 0), stats, whether
    forward refused (forward/backward/step are not ported on the prefetch
    path), whether the closed engine was freed at its last
    reference)}."""
    import weakref

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    torch.set_num_threads(1)
    out = {}
    for mode, cfg, model_kw in cfgs:
        mesh = make_mesh(MeshConfig(data=world), device="cpu")
        model = gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(**model_kw))
        engine, _, _, _ = ds.initialize(
            config=cfg, model=model, mesh=mesh,
            model_parameters={k: torch.from_numpy(v) for k, v in
                              state.items()})
        losses = [float(engine.train_batch(b)) for b in batches]
        full = engine.gather_master()
        stats = dict(engine.prefetch_live_param_stats())
        try:
            engine.forward(batches[0])
            refused = False
        except NotImplementedError:
            refused = True
        engine.close()
        ref = weakref.ref(engine)
        del engine
        out[mode] = (losses, {k: v.numpy() for k, v in full.items()}
                     if rank == 0 else None, stats, refused, ref() is None)
    return out


def heap_kernels(rank, world):
    """Each kernel over a ``world``-rank symmetric heap on the card against
    its plain version: {case: (row-relative error, limit)}. Shards of one
    seeded W (GPT-2-like widths and an uneven M, which take the TMA
    kernels; 7-wide chunks, which take the mma.sync kernels' element-wise
    loads), each rank's own x, lhs and rhs. Each call's launch name is
    checked against the route its shapes take; the wide case also runs
    the mma.sync kernels by name."""
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    from deepspeed_tpu_torch.ops.cuda import tolerance
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from deepspeed_tpu_torch.parallel.symmetric_memory import SymmetricHeap
    mesh = make_mesh(MeshConfig(data=world))
    dev, bf = mesh.device, torch.bfloat16
    cases = {"wide": (200, 256, 384), "uneven": (37, 7 * world, 40)}
    regions = {}
    for case, (M, K, N) in cases.items():
        regions[f"{case}0"] = ((K // world, N), bf)
        regions[f"{case}1"] = ((K, N // world), bf)
    heap = SymmetricHeap(mesh, regions, 4 * max(K * N for _, K, N in
                                                 cases.values()))
    shared = torch.Generator(device=dev).manual_seed(0)
    own = torch.Generator(device=dev).manual_seed(1 + rank)

    def rnd(*shape, gen=own):
        return (0.1 * torch.randn(*shape, generator=gen, device=dev)).to(bf)

    errs = {}
    route = {"wide": "", "uneven": "_mma"}

    def launched(name, fn, *args):
        before = dict(builder.launches)
        out = fn(*args)
        grew = {n for n, c in builder.launches.items()
                if c != before.get(n, 0)}
        if grew != {name}:
            raise AssertionError(f"{name}: launched {sorted(grew)}")
        return out
    for case, (M, K, N) in cases.items():
        W = rnd(K, N, gen=shared)
        for d in (0, 1):
            heap.tensor(f"{case}{d}").copy_(W.chunk(world, dim=d)[rank])
        mesh.barrier()
        for d in (0, 1):
            views = heap.peer_views(heap.tensor(f"{case}{d}"))
            for transpose in (False, True):
                x = rnd(M, N if transpose else K)
                for out_dtype, limit in ((bf, "ag_matmul"),
                                         (torch.float32, "ag_matmul[fp32]")):
                    want = k.ag_matmul_plain(x, views, rank, d, transpose,
                                             out_dtype)
                    runs = [("ag_matmul" + route[case], k.ag_matmul)]
                    if case == "wide":
                        runs.append(("ag_matmul_mma", k.ag_matmul_mma))
                    for name, fn in runs:
                        got = launched(name, fn, x, views, rank, d,
                                       transpose, out_dtype)
                        errs[f"{limit} {name} {case} dim{d} "
                             f"T{int(transpose)}"] = (
                            tolerance.kernel_err(limit, got, want),
                            tolerance.ROW_RTOL[limit])
            lhs, rhs = rnd(M, K), rnd(M, N)
            slot = heap.slot(K * N).view(world, K * N // world)
            want = k.mm_rs_partial_plain(lhs, rhs, d, world)
            if case == "wide":
                launched("mm_rs_partial_mma", k.mm_rs_partial_mma, lhs, rhs,
                         d, world, slot)
                errs[f"mm_rs_partial_mma {case} dim{d}"] = (
                    tolerance.kernel_err("mm_rs_partial", slot, want),
                    tolerance.ROW_RTOL["mm_rs_partial"])
            launched("mm_rs_partial" + route[case], k.mm_rs_partial, lhs, rhs,
                     d, world, slot)
            errs[f"mm_rs_partial {case} dim{d}"] = (
                tolerance.kernel_err("mm_rs_partial", slot, want),
                tolerance.ROW_RTOL["mm_rs_partial"])
            mesh.barrier()
            views = heap.peer_views(slot)
            got = k.mm_rs_reduce(views, rank)
            want = k.mm_rs_reduce_plain(views, rank)
            errs[f"mm_rs_reduce {case} dim{d}"] = (
                tolerance.kernel_err("mm_rs_reduce", got[None], want[None]),
                tolerance.ROW_RTOL["mm_rs_reduce"])
            mesh.barrier()
    torch.cuda.synchronize()
    heap.close()
    return errs


def _unbatched_backward(ctx, dy):
    """``_PrefetchedScan.backward`` with every reduce-scatter its own
    exchange (each streamed leaf's matmul+reduce-scatter and each packed
    group's ring reduce-scatter): the path the layer batch replaced, as
    the reference it must equal bit for bit."""
    from deepspeed_tpu_torch.ops import fused_collective as fc
    from deepspeed_tpu_torch.parallel import prefetch
    body, plan, mesh, mode, fused_ids, cfg, L, nleaf = ctx.spec
    lp, shapes = ctx.lp, ctx.shapes
    saved = ctx.saved_tensors
    xs, flat = saved[:L], saved[L:]
    layers = [flat[i * nleaf:(i + 1) * nleaf] for i in range(L)]
    grads = [None] * len(flat)
    sharded = set(lp.sharded_ids)
    for i in reversed(range(L)):
        bufs = tuple(prefetch._pack([layers[i][j] for j in ids])
                     for _, ids in lp.groups)
        full = prefetch._unpack_layer_full(
            prefetch._gather_groups(bufs, mesh), shapes, lp)
        x_i = xs[i].detach().requires_grad_()
        lt = [full[j].detach().requires_grad_() if j in full
              else layers[i][j].detach().requires_grad_()
              for j in range(nleaf)]
        with torch.enable_grad(), fc.gather_scope(cfg if lp.fused else None):
            y = body(x_i, lt)
        d = torch.autograd.grad(y, [x_i] + lt, dy, allow_unused=True)
        dy = d[0]
        d_leaves = [torch.zeros_like(t) if g is None else g
                    for g, t in zip(d[1:], lt)]
        shards = prefetch._scatter_layer_grads(
            {j: d_leaves[j] for j in sharded}, shapes, lp, mesh)
        for j in range(nleaf):
            grads[i * nleaf + j] = shards.get(j, d_leaves[j])
    return (dy, None, *grads)


def batch_vs_unbatched(rank, world, cfgs, batch):
    """For each (mode, ds_config): one step's gradients (this rank's
    shards, fp32) through the layer batch and through the unbatched
    backward, the gloo exchanges each run made, and the layer batches
    that closed with an exchange (a step's backward); returns {mode:
    (whether every gradient is bit-equal, exchanges batched, exchanges
    unbatched, batch closes, layers, streamed leaves a layer, packed
    groups a layer)}."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel import overlap, prefetch
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    torch.set_num_threads(1)
    out = {}
    for mode, cfg in cfgs:
        mesh = make_mesh(MeshConfig(data=world), device="cpu")
        engine, _, _, _ = ds.initialize(
            config=cfg, model=gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(
                dtype=torch.float32, n_positions=64)), mesh=mesh)
        gathers, closes = [0], [0]
        gather, close = mesh.all_gather, overlap.ReduceScatterBatch.close

        def counted(t):
            gathers[0] += 1
            return gather(t)

        def counted_close(self):
            closes[0] += bool(self.outs)
            return close(self)
        mesh.all_gather = counted
        overlap.ReduceScatterBatch.close = counted_close
        try:
            got, _, _ = engine._zero3_grads(batch)
            n_batched, n_closes = gathers[0], closes[0]
            gathers[0] = 0
            backward = prefetch._PrefetchedScan.backward
            prefetch._PrefetchedScan.backward = staticmethod(
                _unbatched_backward)
            try:
                want, _, _ = engine._zero3_grads(batch)
            finally:
                prefetch._PrefetchedScan.backward = staticmethod(backward)
        finally:
            overlap.ReduceScatterBatch.close = close
            del mesh.all_gather
        lp = engine._lp
        out[mode] = (all(torch.equal(g, w) for g, w in zip(got, want)),
                     n_batched, gathers[0], n_closes, engine._n_layer,
                     len(lp.fused), len(lp.groups))
        engine.close()
    return out


def heap_layer_batch(rank, world):
    """A layer's reduce-scatter batch over a ``world``-rank symmetric heap
    on the card: two streamed leaves' partials (shard dims 0 and 1, bf16
    outputs) by the TMA kernel and an uneven one (7-wide chunks) by the
    mma.sync kernel into the region's columns, and a packed group's flat
    fp32 gradient; the close (one barrier, one mm_rs_reduce launch) against
    mm_rs_reduce_plain over the same regions, bit for bit. Returns
    {entry: (whether equal, its dtype)} and the launches the close made."""
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    from deepspeed_tpu_torch.parallel import overlap
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from deepspeed_tpu_torch.parallel.symmetric_memory import SymmetricHeap
    mesh = make_mesh(MeshConfig(data=world))
    dev, bf = mesh.device, torch.bfloat16
    leaves = {"c_attn": (200, 128, 384, 1), "c_proj": (200, 256, 128, 0),
              "uneven": (37, 7 * world, 40, 0)}
    shards = {name: torch.empty(K * N // world, dtype=bf, device=dev)
              for name, (_, K, N, _) in leaves.items()}
    sizes = {overlap.shard_key(shards[name]): K * N // world
             for name, (_, K, N, _) in leaves.items()}
    sizes[("group", 0)] = 1000
    heap = SymmetricHeap(mesh, {}, 4 * world * overlap.batch_run(
        sizes.values()))
    own = torch.Generator(device=dev).manual_seed(1 + rank)
    outs, launched = {}, {}
    with overlap.reduce_scatter_batch(mesh, sizes) as batch:
        for name, (M, K, N, d) in leaves.items():
            lhs = (0.1 * torch.randn(M, K, generator=own, device=dev)).to(bf)
            rhs = (0.1 * torch.randn(M, N, generator=own, device=dev)).to(bf)
            key = overlap.shard_key(shards[name])
            k.mm_rs_partial(lhs, rhs, d, world, out=batch.columns(key))
            outs[name] = batch.defer(key, (K * N // world,), bf)
        batch.columns(("group", 0)).copy_(torch.randn(
            world, 1000, generator=own, device=dev))
        outs["group"] = batch.defer(("group", 0), (1000,))
        before = dict(builder.launches)
    launched = {n: c - before.get(n, 0) for n, c in builder.launches.items()
                if c != before.get(n, 0)}
    views = heap.peer_views(batch.region)
    want = k.mm_rs_reduce_plain(views, rank)
    errs = {}
    for name, key in zip(outs, list(sizes)):
        off, m = batch.entries[key]
        errs[name] = (torch.equal(outs[name], want[off:off + m].to(
            outs[name].dtype)), str(outs[name].dtype))
    torch.cuda.synchronize()
    mesh.barrier()
    heap.close()
    return errs, launched
