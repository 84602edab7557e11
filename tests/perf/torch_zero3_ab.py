"""A/B of the ZeRO-3 step between two trees of the PyTorch port, on one
card in one call: chip_smoke's ``zero3_train`` (GPT-2 large, 36 layers,
four ranks time-sharing the card, 2 warmup + 4 timed ``train_batch``
steps) in ``fused_matmul`` and then ``ring`` mode, from OLD_TREE, this
tree, this tree again and OLD_TREE again, so that drift of the card or
the host shows on both sides. One JSON line a run and mode (rank 0's step
time, the four ranks' step times, barriers a step and the host time in
them, losses and launches a step), then the card's name and power
limit.

    python3 tests/perf/torch_zero3_ab.py OLD_TREE

OLD_TREE is a directory inside this tree that .gitignore lists (e.g.
build/parent), holding ``git archive`` of the commit to compare with.
Each run builds its tree's kernels first (cached after its first run).
"""

import json
import os
import subprocess
import sys

LAYERS, WARMUP, STEPS, RANKS = 36, 2, 4, 4


MODES = ("fused_matmul", "ring")


def rank_main(rank, world):
    import chip_smoke
    return {mode: chip_smoke.zero3_train(mode, world, LAYERS, WARMUP, STEPS)
            for mode in MODES}


def one_run():
    """This process's tree (the working directory): build, then the four
    ranks, each mode in turn; print rank 0's readings."""
    sys.path.insert(0, os.getcwd())
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.parallel.mesh import spawn
    lib = builder.kernels()
    ranks = spawn(rank_main, RANKS, timeout=1200.0)
    for mode in MODES:
        r0 = ranks[0][mode]
        print(json.dumps({
            "tree": os.getcwd(), "mode": mode, "build_s": lib.build_s,
            "step_ms": r0["step_ms"],
            "step_ms_by_rank": [r[mode]["step_ms"] for r in ranks],
            "barrier_wall_ms_per_step": r0["barrier_wall_ms_per_step"],
            "barrier_wall_ms_per_step_by_rank": [
                r[mode]["barrier_wall_ms_per_step"] for r in ranks],
            "barriers_per_step": r0["barriers_per_step"],
            "launches_per_step": {k: v / STEPS for k, v in
                                  sorted(r0["launches"].items())},
            "losses": r0["losses"]}), flush=True)


def main():
    old = os.path.abspath(sys.argv[1])
    here = os.getcwd()
    for tree in (old, here, here, old):
        env = dict(os.environ, PYTHONPATH=tree)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one"], cwd=tree, env=env,
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode != 0 or len(lines) < len(MODES):
            print(out.stdout[-3000:], out.stderr[-3000:], flush=True)
            raise SystemExit(f"run in {tree} failed ({out.returncode})")
        for line in lines[-len(MODES):]:
            print(line, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    if "--one" in sys.argv[1:]:
        one_run()
    else:
        main()
