"""MoQ boundaries of GPT-2 large on one NVIDIA GPU: device and host time
of ``Quantizer.quantize_tree``, and the quantize kernel's work-list
settings swept.

    python3 tests/perf/torch_moq_boundary.py [--tree DIR] [--sweep]

Without ``--sweep``: the masters of GPT-2 large (chip_smoke.py's
training model, fp32, seeded) in the unrolled layout (146 leaves,
symmetric, nearest, 8 groups: train_moq's block) and in the scan layout
(10 leaves, the 8 stacked [36, .] ones; asymmetric, stochastic, the
blend: train_moq_sr's block), 3 warm-up and 20 timed boundaries each: the
device time between CUDA events around the call and the host time of the
call (the enqueue, no synchronize), medians and ranges; the card is kept
busy for a few ms before each, so that the events do not time the host.
``--tree DIR`` runs the package of the checkout at DIR (an A/B against
another commit in one call).

``--sweep`` (this tree): the whole train_moq boundary as one
``quantize_leaves`` launch, wte [50304, 1280] fp32 alone, c_fc [1280,
5120] fp32 and bf16, wpe [1024, 1280] and a stacked [36, 1280] leaf, each
timed by CUDA-graph replay under each setting of the work list in
``SWEEP`` (window bytes, lag tiles, tile bytes), beside one ``copy_`` of
the same bytes. One JSON line a row, each with the card's name and power
limit.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
if "--tree" in sys.argv:    # the package of another checkout
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--tree")
                                                + 1]))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import (  # noqa: E402
    GPT2LMHeadModel, gpt2_large)
from deepspeed_tpu_torch.runtime.quantize import (  # noqa: E402
    Quantizer, eligible_leaves)

CARD = None


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def emit(obj):
    print(json.dumps(dict(obj, card=CARD,
                          package=os.path.dirname(
                              deepspeed_tpu_torch.__file__))), flush=True)


def masters(scan_layers, seed=0):
    """GPT-2 large's parameters as fp32 tensors on the card ({name:
    tensor}, seeded) and the model's JAX paths."""
    import dataclasses
    cfg = dataclasses.replace(gpt2_large(vocab_size=50304, n_positions=1024,
                                         dtype=torch.float32),
                              scan_layers=scan_layers)
    with torch.device("meta"):
        model = GPT2LMHeadModel(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    named = {n: 0.02 * torch.randn(p.shape, generator=gen, device="cuda")
             for n, p in model.named_parameters()}
    return named, model.jax_paths()


def boundaries(layout, warmup=3, n=20):
    scan = layout == "scan"
    named, paths = masters(scan)
    q = Quantizer(q_start_bits=16, q_target_bits=15, q_period=1,
                  q_groups=8, q_type=1 if scan else 0,
                  q_rounding=1 if scan else 0, q_mixed_fp16=scan,
                  q_change_ratio=0.001)
    leaves = eligible_leaves(named, paths)
    elems = sum(named[m].numel() for _, names, _ in leaves for m in names)
    dev_ms, host_us = [], []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # the card busy for a few ms, so that the events time the
        # boundary's device work and not the host's enqueueing of it
        torch.cuda._sleep(40_000_000)
        start.record()
        t0 = time.perf_counter()
        q.quantize_tree(named, paths)
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        if i >= warmup:
            dev_ms.append(start.elapsed_time(end))
            host_us.append((t1 - t0) * 1e6)
    emit({"row": "boundary", "layout": layout, "leaves": len(leaves),
          "elements": elems, "bound_ms": 8 * elems / 3.35e12 * 1e3,
          "device_ms_median": statistics.median(dev_ms),
          "device_ms_min": min(dev_ms), "device_ms_max": max(dev_ms),
          "host_us_median": statistics.median(host_us),
          "host_us_min": min(host_us), "host_us_max": max(host_us)})


def sweep():
    from chip_smoke import time_graph_ms
    from deepspeed_tpu_torch.ops.cuda import quantize as cq
    named, paths = masters(False)
    table = [([named[m] for m in names], 15, 8)
             for _, names, _ in eligible_leaves(named, paths)]
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return 0.02 * torch.randn(*shape, generator=gen, device="cuda")
    rows = {"boundary": table, "wte": [([named["wte"]], 15, 8)],
            "c_fc": [([rnd(1280, 5120)], 8, 8)],
            "c_fc_bf16": [([rnd(1280, 5120).bfloat16()], 8, 8)],
            "wpe": [([rnd(1024, 1280)], 15, 8)],
            "stacked_36x1280": [([rnd(1280) for _ in range(36)], 15, 8)]}
    # a graph of n calls a row (small rows: n so that the replay's own
    # launch cost is spread)
    reps = {"boundary": 1, "wte": 4, "c_fc": 36, "c_fc_bf16": 36,
            "wpe": 36, "stacked_36x1280": 36}
    for name, tab in rows.items():
        nbytes = sum(p.numel() * p.element_size() for ps, _, _ in tab
                     for p in ps)
        src = torch.empty(nbytes // 4, device="cuda")
        dst = torch.empty_like(src)
        copy_ms = time_graph_ms(lambda i: dst.copy_(src), n=reps[name])
        del src, dst
        emit({"row": name, "bytes": nbytes, "copy_ms": copy_ms,
              "bound_ms": 2 * nbytes / 3.35e12 * 1e3})
    names = ("WINDOW_BYTES", "LAG_TILES", "TILE_BYTES")
    base = {k: getattr(cq, k) for k in names}
    settings = [dict(base)] + [dict(base, **v) for v in SWEEP] + [dict(base)]
    for setting in settings:
        for k, v in setting.items():
            setattr(cq, k, v)
        for name, tab in rows.items():
            ms = time_graph_ms(lambda i: cq.quantize_leaves(tab, True),
                               n=reps[name])
            emit({"row": name, **{k.lower(): v for k, v in setting.items()},
                  "ms": ms})
    for k, v in base.items():
        setattr(cq, k, v)


# the work-list settings --sweep tries, each a change from the module's
SWEEP = [dict(WINDOW_BYTES=w << 20, LAG_TILES=lag)
         for w, lag in ((12, 0), (12, 64), (10, 0), (14, 0), (16, 0))] + [
    dict(TILE_BYTES=65536)]


def main():
    global CARD
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    CARD = card()
    if "--sweep" in sys.argv:
        sweep()
        return 0
    for layout in ("unrolled", "scan"):
        boundaries(layout)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
