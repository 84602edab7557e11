"""LLaMA-7B's fast path timed as bench.py's bench_llama_decode times it,
from a chosen tree of the port: per batch the best of 3 of t(4 new) (the
prompt pass over 1968 tokens and 3 decode steps) and of t(68 new) -
t(4 new) over 64 decode steps, over the seed-0 weights quantized to int8
codes and an int8 cache (chip_smoke.py's generate_llama_int8 case).

    python3 tests/perf/torch_llama_t4.py [--tree DIR] [--batches 8 1]

``--tree`` imports deepspeed_tpu_torch from DIR (another checkout, such as
an older commit unpacked there by ``git archive``), so that two trees are
timed the same way in one call. One JSON line a batch, with the card's
name and power limit.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

GEN_CTX, SHORT, LONG = 2048, 4, 68
LLAMA_INIT_STD = 0.02 * math.sqrt(1280 / 4096)     # chip_smoke.py's
SERVING_INT8 = {"slots": 8, "page_size": 16, "max_pages_per_slot": 64,
                "quantize_bits": 8, "kv_cache_bits": 8}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 1])
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.models.llama import llama_7b
    from deepspeed_tpu_torch.models import llama_inference as li
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cfg = llama_7b()
    eng = serving.build_engine(
        "llama", cfg, li.init_serving_params(cfg, seed=0, device="cuda",
                                             std=LLAMA_INIT_STD),
        config={"serving": SERVING_INT8})
    p = eng.adapter.p

    def run(prompt, new):
        toks = li.llama_fast_generate(cfg, p, prompt, max_new_tokens=new,
                                      max_out_tokens=GEN_CTX,
                                      kv_cache_bits=8)
        int(toks[0, -1])                 # the bench's fence: read a token
        return toks

    for bs in args.batches:
        prompt = np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(bs, GEN_CTX - 80)).astype(np.int32)
        run(prompt, SHORT)
        run(prompt, LONG)
        t4 = decode = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            run(prompt, SHORT)
            t_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            run(prompt, LONG)
            t4 = min(t4, t_s)
            decode = min(decode, time.perf_counter() - t0 - t_s)
        print(json.dumps({"tree": tree, "batch": bs, "t4_ms": t4 * 1e3,
                          "decode_ms_per_step": decode / (LONG - SHORT)
                          * 1e3, "card": card}), flush=True)


if __name__ == "__main__":
    main()
