"""Rank bodies for the n-rank ZeRO-3 gather-path tests
(tests/test_torch_zero3_gather.py). They run in processes started by
``deepspeed_tpu_torch.parallel.mesh.spawn`` and import nothing of JAX."""

import os

import numpy as np
import torch

from torch_zero_stages_worker import (eval_logits, resume,  # noqa: F401
                                      save_and_resume, weighted_loss)


def _model(family, model_kw):
    if family == "llama":
        from deepspeed_tpu_torch.models import llama
        return llama.LlamaForCausalLM(llama.llama_tiny(**model_kw))
    from deepspeed_tpu_torch.models import gpt2
    return gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(**model_kw))


def _whole(engine, tensors):
    """The rank's shards of every leaf (by the engine's plan) gathered
    whole over gloo, by name, as numpy."""
    out = {}
    for name, t, e in zip(engine.param_names, tensors, engine._plan):
        t = t.detach().float().cpu()
        if e is not None:
            t = torch.cat(engine.mesh.all_gather(t.contiguous()), dim=e[0])
        out[name] = t.numpy().copy()
    return out


def _fwd_bwd_step(engine, batch):
    """One optimizer step through forward/backward/step over the gas micro
    batches of ``batch``: the mean of the micro batches' losses."""
    gas = engine.gradient_accumulation_steps()
    rows = batch["input_ids"].shape[0] // gas
    acc = 0.0
    for i in range(gas):
        loss = engine.forward({"input_ids": batch["input_ids"][
            i * rows:(i + 1) * rows]})
        engine.backward(loss)
        acc += float(loss) / gas
        engine.step()
    return acc


def gather_cases(rank, world, cases, state, batches, model_kw):
    """For each (name, ds_config, kind, family) in ``cases``: the tiny
    model of ``family`` ("gpt2" or "llama") from the numpy ``state``, then
    ``batches`` through ``train_batch`` (kind "train"), with the weighted
    user loss (kind "loss_fn"), or (kind "mixed") the first and the last
    through ``train_batch`` and the ones between through
    ``forward``/``backward``/``step``. Returns {name: (losses, masters by
    name, exp_avg and exp_avg_sq by name (rank 0), loss scales after each
    step, the engine's zero3_path, its plan, the offload tier's class
    name or None, whether the module's parameters hold no storage after
    the run, the swap directories under nvme_path)}."""
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    out = {}
    for name, cfg, kind, family in cases:
        mesh = make_mesh(MeshConfig(data=world), device="cpu")
        engine, _, _, _ = ds.initialize(
            config=cfg, model=_model(family, model_kw.get(family, {})),
            mesh=mesh, loss_fn=weighted_loss if kind == "loss_fn" else None,
            model_parameters={k: torch.from_numpy(v)
                              for k, v in state[family].items()})
        losses, scales = [], []
        for i, b in enumerate(batches):
            if kind == "mixed" and 0 < i < len(batches) - 1:
                losses.append(_fwd_bwd_step(engine, b))
            else:
                losses.append(float(engine.train_batch(b)))
            scales.append(engine.loss_scale)
        runner = engine._host_runner
        sd = runner.state_dict() if runner is not None else engine.opt_state
        moments = {k: _whole(engine, sd[k]) for k in ("exp_avg",
                                                      "exp_avg_sq")}
        dirs = None
        if getattr(runner, "swapper", None) is not None:
            dirs = sorted(os.listdir(os.path.dirname(
                runner.swapper.swapper.dir)))
        masters = {k: v.numpy() for k, v in engine.gather_master().items()}
        empty = all(p.numel() == 0 for p in engine.module.parameters())
        out[name] = (losses, masters if rank == 0 else None,
                     moments if rank == 0 else None, scales,
                     engine.zero3_path, list(engine._plan),
                     None if runner is None else type(runner).__name__,
                     empty, dirs)
        engine.close()
    return out


def _plain_reduce(slots, rank, out=None, outs=None):
    """mm_rs_reduce's plain version behind the kernel's signature."""
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    result = k.mm_rs_reduce_plain(slots, rank)
    if outs is not None:
        return k.mm_rs_reduce_fill(result, outs)
    return result if out is None else out.copy_(result)


def heap_gather_path(rank, world):
    """The gather path on the card over a ``world``-rank symmetric heap:
    tiny GPT-2 at head dim 64 in bf16 at stage 3 at a bucket of 20000
    elements. Without prefetch: 3 ``train_batch`` steps. With prefetch:
    ``train_batch``, a step through ``forward``/``backward``/``step`` (the
    gather path's heap slots sized for the prefetch engine's buckets),
    ``train_batch``, then ``eval_batch``. Each engine again with
    mm_rs_reduce's plain version in the kernel's place (the prefetch
    path's layer reduces too). Returns {"gather" | "prefetch": (whether the
    losses, the gathered masters and the eval logits are bit for bit
    equal, the first run's launches over the steps that ran the bucket
    stream, its buckets a step times those steps, the eval logits'
    shape)}."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, 512, (4 * world, 64)), device="cuda")
    kernel = k.mm_rs_reduce
    out = {}
    for path, prefetch in (("gather", False), ("prefetch", True)):
        cfg = {"train_batch_size": 4 * world, "bf16": {"enabled": True},
               "data_types": {"grad_dtype": "bf16"},
               "gradient_clipping": 1.0,
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
               "zero_optimization": {
                   "stage": 3, "reduce_bucket_size": 20000,
                   "stage3_prefetch": prefetch,
                   "stage3_param_persistence_threshold": 0}}
        runs = []
        for plain in (False, True):
            if plain:
                k.mm_rs_reduce = _plain_reduce
            try:
                mesh = make_mesh(MeshConfig(data=world))
                engine, _, _, _ = ds.initialize(
                    config=cfg, mesh=mesh, model=gpt2.GPT2LMHeadModel(
                        gpt2.gpt2_tiny(n_embd=128, n_head=2, n_positions=64,
                                       dtype=torch.bfloat16)))
                assert engine.zero3_path == path, engine.zero3_path
                batch = {"input_ids": ids}
                if prefetch:
                    losses = [float(engine.train_batch(batch))]
                    builder.launches.clear()
                    losses.append(_fwd_bwd_step(engine, batch))
                    launched = dict(builder.launches)
                    losses.append(float(engine.train_batch(batch)))
                    logits = engine.eval_batch(batch).float().cpu()
                    steps = 1
                else:
                    builder.launches.clear()
                    losses = [float(engine.train_batch(batch))
                              for _ in range(3)]
                    launched = dict(builder.launches)
                    logits = torch.zeros(0)
                    steps = 3
                runs.append((losses, engine.gather_master(), logits,
                             launched, steps * len(engine._buckets)))
                engine.close()
            finally:
                k.mm_rs_reduce = kernel
        (a, ma, la, launched, buckets), (b, mb, lb, _, _) = runs
        equal = (a == b and all(torch.equal(ma[n], mb[n]) for n in ma)
                 and torch.equal(la, lb) and all(map(np.isfinite, a)))
        out[path] = (equal, launched, buckets, tuple(la.shape))
    return out


def run_jobs(rank, world, jobs):
    """Each (name of a function of this module, its arguments after
    rank and world) in ``jobs``, in order, in one world: [results]."""
    return [globals()[name](rank, world, *args) for name, *args in jobs]
