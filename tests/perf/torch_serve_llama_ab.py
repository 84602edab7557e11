"""LLaMA-7B's paged serving (chip_smoke.py's serve_llama and
serve_llama_int8 phases: 8 slots, the seed-0 weights at LLAMA_INIT_STD,
N_REQUESTS greedy requests from seed 0) timed several times over one
engine, from a chosen tree of the port, so that a change of the decode
step can be told from the run-to-run spread of a host-bound path.

    python3 tests/perf/torch_serve_llama_ab.py [--tree DIR] [--repeats 5]

``--tree`` imports deepspeed_tpu_torch from DIR (another checkout, such as
an older commit unpacked there by ``git archive``); the traffic and the
serving settings are this checkout's chip_smoke.py's. One JSON line an
engine: each repeat's decode ms a step (the ticks' time over the tick
steps, as chip_smoke reports it), their median, the launches of the last
repeat and the card's name and power limit.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_settings", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.models.llama import llama_7b
    from deepspeed_tpu_torch.models.llama_inference import \
        init_serving_params
    from deepspeed_tpu_torch.ops.cuda import builder
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cfg = llama_7b()
    for name, settings in (("serve_llama", smoke.SERVING),
                           ("serve_llama_int8", smoke.SERVING_INT8)):
        eng = serving.build_engine(
            "llama", cfg, init_serving_params(cfg, seed=0, device="cuda",
                                              std=smoke.LLAMA_INIT_STD),
            config={"serving": settings})
        rs = np.random.RandomState(0)
        eng.serve([serving.Request("warm", rs.randint(0, cfg.vocab_size, 40),
                                   max_new_tokens=4)])
        steps = []
        for _ in range(args.repeats):
            batcher = serving.ContinuousBatcher(eng.adapter)
            reqs = smoke.traffic(cfg, np.random.RandomState(0))
            torch.cuda.synchronize()
            builder.launches.clear()
            batcher.serve(reqs)
            torch.cuda.synchronize()
            tick_s = batcher.metrics_snapshot()["tick_latency_s"]["sum"]
            steps.append(tick_s / batcher.stats["tick_steps"] * 1e3)
        print(json.dumps({"tree": tree, "engine": name,
                          "ms_per_decode_step": steps,
                          "median_ms": statistics.median(steps),
                          "tick_steps": batcher.stats["tick_steps"],
                          "launches": dict(builder.launches),
                          "card": card}), flush=True)
        del eng
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
