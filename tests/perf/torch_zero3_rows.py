"""The ZeRO-3 fused collective kernels' rows (chip_smoke.py's
``zero3_kernel_phase``: ``ag_matmul`` and ``mm_rs_partial`` at GPT-2
large's four projections, M 2048 tokens a rank over 4 local "peers", and
that tree's ``mm_rs_reduce``) from a chosen tree of the port, each row
held against its plain version and timed by CUDA-graph replay.

    python3 tests/perf/torch_zero3_rows.py [--tree DIR]

``--tree`` runs DIR's chip_smoke.py and kernels (another checkout, such
as an older commit unpacked there by ``git archive``), so that two trees
are timed the same way in one call: run it old / new / new / old. One
JSON line a row (its name, leaf and direction, kernel and library µs,
bound), then the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke
    from deepspeed_tpu_torch.ops.cuda import builder
    builder.kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for row in chip_smoke.zero3_kernel_phase(gen):
        print(json.dumps({
            "tree": tree, "name": row["name"],
            "kernel_us": row["ms"] * 1e3, "bound_us": row["bound_ms"] * 1e3,
            "pct_of_bound": 100.0 * row["bound_ms"] / row["ms"],
            "library_us": None if row["library_ms"] is None
            else row["library_ms"] * 1e3}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
