"""Rank bodies for the n-rank ZeRO-Offload tests
(tests/test_torch_zero_offload.py). They run in processes started by
``deepspeed_tpu_torch.parallel.mesh.spawn`` and import nothing of JAX."""

import os

import torch

from torch_zero_stages_worker import (_engine, resume,  # noqa: F401
                                      save_and_resume, weighted_loss)


def _whole(engine, tensors):
    """The rank's slices of every leaf (by the engine's moment plan)
    gathered whole over gloo, by name, as numpy."""
    out = {}
    for name, t, e in zip(engine.param_names, tensors, engine._plan):
        t = t.detach().float().cpu()
        if e is not None:
            t = torch.cat(engine.mesh.all_gather(t.contiguous()), dim=e[0])
        out[name] = t.numpy().copy()
    return out


def offload_cases(rank, world, cases, state, batches, model_kw):
    """For each (name, ds_config, kind) in ``cases``: the tiny GPT-2 from
    the numpy ``state``, then ``batches`` through ``train_batch`` (kind
    "train"), ``forward``/``backward``/``step`` over the gas micro
    batches of each (kind "fwd_bwd_step"), or with the weighted user loss
    (kind "loss_fn"). Returns {name: (losses, masters by name, exp_avg
    and exp_avg_sq by name, loss scales after each step, the tier's
    class name, the shapes of the tier's leaves, the swap directory's
    file sizes and the directories under nvme_path (NVMe only), the
    last step's global gradient norm)}."""
    torch.set_num_threads(1)
    out = {}
    for name, cfg, kind in cases:
        engine = _engine(world, cfg, state, model_kw,
                         weighted_loss if kind == "loss_fn" else None)
        runner = engine._host_runner
        losses, scales = [], []
        for b in batches:
            if kind == "fwd_bwd_step":
                gas = engine.gradient_accumulation_steps()
                rows = b["input_ids"].shape[0] // gas
                acc = 0.0
                for i in range(gas):
                    loss = engine.forward(
                        {"input_ids": b["input_ids"][i * rows:
                                                     (i + 1) * rows]})
                    engine.backward(loss)
                    acc += float(loss) / gas
                    engine.step()
                losses.append(acc)
            else:
                losses.append(float(engine.train_batch(b)))
            scales.append(engine.loss_scale)
        sd = runner.state_dict()
        swap = dirs = None
        if getattr(runner, "swapper", None) is not None:
            here = runner.swapper.swapper.dir
            swap = {f: os.path.getsize(os.path.join(here, f))
                    for f in sorted(os.listdir(here))}
            dirs = sorted(os.listdir(os.path.dirname(here)))
        masters = {k: v.numpy() for k, v in engine.gather_master().items()}
        out[name] = (losses, masters,
                     {k: _whole(engine, sd[k])
                      for k in ("exp_avg", "exp_avg_sq")},
                     scales, type(runner).__name__,
                     [tuple(t.shape) for t in runner.master_leaves()],
                     swap, dirs, float(engine.get_global_grad_norm()))
        engine.close()
    return out


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

