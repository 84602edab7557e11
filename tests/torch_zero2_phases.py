"""chip_smoke.py's ZeRO stage 0-2 phases alone, on the card.

    python3 tests/torch_zero2_phases.py [--layers L] [--skip-zero3]
                                        [--offload] [--gather]

Runs chip_smoke's device phase, the one-card GPT-2 train phase (2 + 10
steps: the losses the stage-2 run is held to), then train_zero3_ring's
run alone (four ranks, ZeRO-3 prefetch, ring gathers: the other losses
it is held to; ``--skip-zero3`` holds the stage-2 run to the one-card
losses alone, for a quicker check), then ``zero2_kernels`` (mm_rs_reduce
at the default plan's first and last bucket) and ``train_zero2`` /
``zero2_restore`` (four ranks at ZeRO stage 2, save, resume at four and
at one). With ``--offload`` then ``train_zero2_offload`` /
``zero2_offload_restore`` (the same four ranks with the optimizer state
in pinned host memory or on NVMe, held to train_zero2's losses). With
``--gather`` the same worlds also run ZeRO stage 3's gather path:
``train_zero3_gather``, ``train_zero3_llama`` and
``zero3_gather_restore`` in train_zero2's world, and with ``--offload``
``train_zero3_gather_offload`` in the offload world.
``--layers`` cuts the depth of every GPT-2 run (a quick first call).
Each prints its chip_smoke line.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402


def ring_rank(rank, world, n_layer, warmup, steps):
    """One rank of train_zero3_ring's run."""
    return c.zero3_train("ring", world, n_layer, warmup, steps)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.parallel.mesh import spawn
    layers = 36
    if "--layers" in sys.argv:
        layers = int(sys.argv[sys.argv.index("--layers") + 1])
    _, rates = c.phase_device()
    engine, _, _ = c.train_phase(n_layer=layers)
    del engine
    torch.cuda.empty_cache()
    if "--skip-zero3" in sys.argv:
        c.ZERO3_RING_LOSSES[:] = c.TRAIN_LOSSES[:c.ZERO3_WARMUP
                                                + c.ZERO3_STEPS]
    else:
        ring = spawn(ring_rank, c.ZERO3_RANKS, layers, c.ZERO3_WARMUP,
                     c.ZERO3_STEPS, timeout=900.0)
        c.ZERO3_RING_LOSSES[:] = ring[0]["losses"]
        c.emit({"phase": "train_zero3_ring", "layers": layers,
                "step_ms": ring[0]["step_ms"],
                "losses": ring[0]["losses"]})
    gen = torch.Generator(device="cuda").manual_seed(0)
    gather = "--gather" in sys.argv
    rows = c.zero2_kernel_phase(gen)
    launches = c.zero2_train_phase(n_layer=layers, gather=gather)
    if gather:
        launches, (gathered, _) = launches
        rows += [dict(row, path="train_zero3_gather",
                      launches=gathered.get(row["name"], 0))
                 for row in rows]
    for row in rows:
        if row["path"] == "train_zero2":
            row["launches"] = launches.get(row["name"], 0)
    if "--offload" in sys.argv:
        torch.cuda.empty_cache()
        launches = c.zero2_offload_phase(rates, n_layer=layers,
                                         gather=gather)
        if gather:
            launches, gathered = launches
            rows += [dict(row, path="train_zero3_gather_offload",
                          launches=gathered.get(row["name"], 0))
                     for row in rows if row["path"] == "train_zero2"]
        rows += [dict(row, path="train_zero2_offload",
                      launches=launches.get(row["name"], 0))
                 for row in rows if row["path"] == "train_zero2"]
    c.emit({"kernels": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
