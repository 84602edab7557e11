"""Rank bodies for the n-rank ZeRO stage 0-2 tests
(tests/test_torch_zero_stages.py). They run in processes started by
``deepspeed_tpu_torch.parallel.mesh.spawn`` and import nothing of JAX."""

import numpy as np
import torch


def _engine(world, cfg, state, model_kw, loss_fn=None):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    mesh = make_mesh(MeshConfig(data=world), device="cpu")
    engine, _, _, _ = ds.initialize(
        config=cfg, model=gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(**model_kw)),
        mesh=mesh, loss_fn=loss_fn,
        model_parameters={k: torch.from_numpy(v) for k, v in state.items()})
    return engine


def _masters(engine, rank):
    """The fp32 masters by name (rank 0), copied off the engine."""
    full = engine.gather_master()
    return {k: v.numpy().copy() for k, v in full.items()} if rank == 0 \
        else None


def weighted_loss(model, batch):
    """The user loss of the tests: the LM loss of the logits scaled row by
    row by ``batch["w"]`` (an inf there makes the step overflow)."""
    from deepspeed_tpu_torch.models.gpt2 import lm_loss
    ids = batch["input_ids"]
    return lm_loss(model(ids) * batch["w"][:, None, None], ids)


def train_cases(rank, world, cases, state, batches, model_kw):
    """For each (name, ds_config, kind) in ``cases``: the tiny GPT-2 from
    the numpy ``state``, then ``batches`` through ``train_batch`` (kind
    "train"), through ``forward``/``backward``/``step`` over the gas
    micro batches of each (kind "fwd_bwd_step"), or with the weighted
    user loss (kind "loss_fn"). Returns {name: (losses, masters by name
    on rank 0, the bucket plan's leaf ids, the moment plan, the loss
    scales after each step, the forward losses)}."""
    torch.set_num_threads(1)
    out = {}
    for name, cfg, kind in cases:
        engine = _engine(world, cfg, state, model_kw,
                         weighted_loss if kind == "loss_fn" else None)
        losses, scales, fwd = [], [], []
        for b in batches:
            if kind == "fwd_bwd_step":
                gas = engine.gradient_accumulation_steps()
                rows = b["input_ids"].shape[0] // gas
                acc = 0.0
                for i in range(gas):
                    micro = {"input_ids": b["input_ids"][i * rows:
                                                         (i + 1) * rows]}
                    loss = engine.forward(micro)
                    fwd.append(float(loss))
                    engine.backward(loss)
                    acc += float(loss) / gas
                    engine.step()
                losses.append(acc)
            else:
                losses.append(float(engine.train_batch(b)))
            scales.append(engine.loss_scale)
        out[name] = (losses, _masters(engine, rank),
                     [b.leaf_ids for b in engine._buckets],
                     list(engine._plan), scales, fwd)
        engine.close()
    return out


def eval_logits(rank, world, cfg, state, ids, model_kw):
    """``eval_batch`` at world ``world``: every rank's logits."""
    torch.set_num_threads(1)
    engine = _engine(world, cfg, state, model_kw)
    return engine.eval_batch({"input_ids": ids}).numpy()


def save_and_resume(rank, world, cfg, state, batches, nxt, ckpt_dir,
                    model_kw):
    """Train on ``batches``, save to ``ckpt_dir`` (every rank writes its
    pieces), take the step on ``nxt``; then a fresh engine loads the save
    and takes the same step. Returns (the uninterrupted losses and next
    loss, the resumed next loss, the files the save wrote)."""
    import os
    torch.set_num_threads(1)
    engine = _engine(world, cfg, state, model_kw)
    losses = [float(engine.train_batch(b)) for b in batches]
    engine.save_checkpoint(ckpt_dir, tag="t")
    files = sorted(os.listdir(os.path.join(ckpt_dir, "t")))
    want = float(engine.train_batch(nxt))
    engine.close()
    fresh = _engine(world, cfg, state, model_kw)
    fresh.load_checkpoint(ckpt_dir)
    got = float(fresh.train_batch(nxt))
    fresh.close()
    return losses, want, got, files


def resume(rank, world, cfg, state, ckpt_dir, nxt, model_kw):
    """A fresh engine loads ``ckpt_dir`` (written at any world size, by
    either package) and takes the step on ``nxt``: (the loss, the global
    step, the masters by name on rank 0 before the step)."""
    torch.set_num_threads(1)
    engine = _engine(world, cfg, state, model_kw)
    engine.load_checkpoint(ckpt_dir)
    before = _masters(engine, rank)
    loss = float(engine.train_batch(nxt))
    return loss, engine.global_steps, before


def heap_bucket_exchange(rank, world, bucket_elems):
    """The bucket stream over a ``world``-rank symmetric heap on the card:
    bf16 and fp32 leaves of GPT-2-like shapes, several buckets with a
    padded tail, through ``bucketed_allreduce`` (one ``mm_rs_reduce``
    launch a bucket) and through the same exchange with the reduce's
    plain version in the kernel's place; then the updated-slice
    all-gather. Returns (whether every reduced leaf is bit-equal to the
    plain run's, the launches a run, the buckets, whether every gathered
    leaf equals the rank-order concatenation of the ranks' slices)."""
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    from deepspeed_tpu_torch.parallel import overlap
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from deepspeed_tpu_torch.parallel.symmetric_memory import SymmetricHeap
    mesh = make_mesh(MeshConfig(data=world))
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(1 + rank)
    shapes = [(64, 192), (192,), (64, 64), (64,), (37,), (256, 64), (3,)]
    leaves = [torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16 if i % 2 else torch.float32)
        for i, s in enumerate(shapes)]
    buckets = overlap.plan_buckets(shapes, bucket_elems, world)
    SymmetricHeap(mesh, {}, 4 * max(b.padded for b in buckets))
    before = dict(builder.launches)
    got = overlap.bucketed_allreduce(leaves, mesh, bucket_elems,
                                     buckets=buckets)
    launched = {n: c - before.get(n, 0) for n, c in builder.launches.items()
                if c != before.get(n, 0)}
    kernel, k.mm_rs_reduce = k.mm_rs_reduce, (
        lambda parts, rank: k.mm_rs_reduce_plain(parts, rank))
    try:
        want = overlap.bucketed_allreduce(leaves, mesh, bucket_elems,
                                          buckets=buckets)
    finally:
        k.mm_rs_reduce = kernel
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    full = [torch.full((world * 8, 6), float(rank), device=dev),
            torch.full((5, world * 4), float(rank), device=dev)]
    plan = [(0, 8), (1, 4)]
    for t, (d, size) in zip(full, plan):
        t.narrow(d, rank * size, size).fill_(100.0 + rank)
    overlap.all_gather_slices(full, plan, mesh,
                              overlap.plan_buckets([t.shape for t in full],
                                                   48, world))
    gathered = all(torch.equal(t.narrow(d, r * size, size),
                               torch.full_like(t.narrow(d, r * size, size),
                                               100.0 + r))
                   for t, (d, size) in zip(full, plan) for r in range(world))
    torch.cuda.synchronize()
    mesh.heap.close()
    return equal, launched, len(buckets), gathered


def bucket_streams(rank, world, shapes, bucket_elems, seed):
    """``bucketed_allreduce`` over gloo: each rank's leaves drawn from
    ``seed`` + rank. Returns the reduced leaves as numpy."""
    from deepspeed_tpu_torch.parallel import overlap
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(MeshConfig(data=world), device="cpu")
    rs = np.random.RandomState(seed + rank)
    leaves = [torch.from_numpy(rs.randn(*s).astype(np.float32))
              for s in shapes]
    return [t.numpy()
            for t in overlap.bucketed_allreduce(leaves, mesh, bucket_elems)]


def run_jobs(rank, world, jobs):
    """Each (name of a function of this module, its arguments after
    rank and world) in ``jobs``, in order, in one world: [results]."""
    return [globals()[name](rank, world, *args) for name, *args in jobs]


def poisoned_jobs(rank, world, jobs):
    """``run_jobs`` in a process where jax, flax and deepspeed_tpu cannot
    be imported (the port's lazy imports included)."""
    import sys
    for name in ("jax", "jaxlib", "flax", "deepspeed_tpu"):
        sys.modules[name] = None
    return run_jobs(rank, world, jobs)
