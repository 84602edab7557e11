"""``mm_rs_reduce`` at GPT-2 large's ZeRO-3 layer (4 ranks' [4, run]
exchange regions: the four streamed leaves' dW to bf16, the packed group
to fp32), rebuilt with ``kReduceUnits`` (the units of 4 fp32 elements a
thread takes an iteration, csrc/fused_collective.cu) set to each of 1, 2,
3, 4, 6 and 8, each held bit for bit against mm_rs_reduce_plain and
timed by CUDA-graph replay (36 calls a graph, the median of 15 replays),
twice in turns; then ``torch.sum`` over the same rows in one local
buffer, and the bytes bound.

    python3 tests/perf/torch_reduce_sweep.py

One JSON line a variant and round, then the card's name and power limit.
"""

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
UNITS = (1, 2, 3, 4, 6, 8)
RANKS, RANK, CALLS, REPLAYS = 4, 1, 36, 15


def build(tmp):
    """{units: the variant library's dstpu_mm_rs_reduce}, built together."""
    from deepspeed_tpu_torch.ops.cuda import builder
    with open(os.path.join(builder.CSRC, "fused_collective.cu")) as f:
        text = f.read()
    anchor = re.compile(r"constexpr int kReduceUnits = \d+;")
    if len(anchor.findall(text)) != 1:
        raise RuntimeError("kReduceUnits is not in the source once")
    procs = {}
    for u in UNITS:
        path = os.path.join(tmp, f"reduce_u{u}.cu")
        with open(path, "w") as f:
            f.write(anchor.sub(f"constexpr int kReduceUnits = {u};", text))
        procs[u] = (path + ".so", subprocess.Popen(
            [builder._nvcc(), *builder.NVCC_FLAGS, "-shared", "-I",
             builder.CSRC, "-o", path + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for u, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on kReduceUnits {u}:\n{out}")
        fn = ctypes.CDLL(lib).dstpu_mm_rs_reduce
        fn.argtypes = builder.SIGNATURES["dstpu_mm_rs_reduce"]
        fn.restype = ctypes.c_int
        fns[u] = fn
    return fns


def graph_us(call):
    """Median µs of one call over REPLAYS replays of CALLS calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPLAYS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / CALLS * 1e3)
    return statistics.median(times)


def main():
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    from deepspeed_tpu_torch.parallel import overlap
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    scratch = os.path.join(ROOT, "deepspeed_tpu_torch", "csrc", "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        fns = build(tmp)
        n = RANKS
        sizes = [1280 * 3840 // n, 1280 * 1280 // n, 1280 * 5120 // n,
                 5120 * 1280 // n, (3840 + 5120) // n]
        dtypes = [torch.bfloat16] * 4 + [torch.float32]
        offs = [overlap.batch_run(sizes[:i]) for i in range(len(sizes))]
        run = overlap.batch_run(sizes)
        gen = torch.Generator(device="cuda").manual_seed(0)
        regions = [torch.randn(n, run, generator=gen, device="cuda")
                   for _ in range(n)]
        outs = [(o, torch.empty(m, dtype=dt, device="cuda"))
                for o, m, dt in zip(offs, sizes, dtypes)]
        want = k.mm_rs_reduce_fill(
            k.mm_rs_reduce_plain(regions, RANK),
            [(o, torch.empty_like(t)) for o, t in outs])
        meta = (ctypes.c_int * (3 * len(outs)))(*[
            v for o, t in outs
            for v in (o, t.numel(), int(t.dtype == torch.float32))])
        slots, ptrs = k._table(regions), k._table([t for _, t in outs])
        bound_us = (4 * n * sum(sizes) + sum(
            m * torch.empty((), dtype=dt).element_size()
            for m, dt in zip(sizes, dtypes))) / 3.35e12 * 1e6
        for rnd in range(2):
            for u, fn in fns.items():
                def call(fn=fn):
                    err = fn(slots, n, RANK, run, ptrs, meta, len(outs), 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"cudaError_t {err}")
                call()
                torch.cuda.synchronize()
                equal = all(torch.equal(a, b)
                            for (_, a), (_, b) in zip(outs, want))
                us = graph_us(call)
                print(json.dumps({"kReduceUnits": u, "round": rnd, "us": us,
                                  "pct_of_bound": 100 * bound_us / us,
                                  "bit_equal": equal, "card": card}),
                      flush=True)
        x = torch.stack([regions[(RANK + 1 + j) % n][RANK]
                         for j in range(n)])
        print(json.dumps({"torch_sum_us": graph_us(lambda: torch.sum(x, 0)),
                          "bound_us": bound_us, "card": card}), flush=True)


if __name__ == "__main__":
    main()
