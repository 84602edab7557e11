"""Rank bodies for the n-rank ZeRO-3 tests (tests/test_torch_zero3.py,
tests/test_torch_fused_collective.py). They run in processes started by
``deepspeed_tpu_torch.parallel.mesh.spawn`` and import nothing of JAX."""

import torch


def train_modes(rank, world, cfgs, state, batches):
    """For each (mode, ds_config) in ``cfgs``: the tiny GPT-2 from the
    ``state`` dict (numpy), ``train_batch`` over ``batches``; returns
    {mode: (losses, gathered fp32 params by name (rank 0), stats, whether
    save_checkpoint refused, whether the closed engine was freed at its
    last reference)}."""
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
            engine.save_checkpoint("unused")
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
