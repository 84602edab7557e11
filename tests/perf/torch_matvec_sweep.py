"""Device time of the decode matvec kernels at LLaMA-7B widths, bf16
weights against int8 codes, over the slot count B.

    python3 tests/perf/torch_matvec_sweep.py [--layers 4]

Prints one JSON line per (kernel, weights, B) with the time of one call
(CUDA-graph replay over the layers, so the weights come cold from HBM),
its byte bound at 3.35 TB/s and the fp32 FMA time floor of the products
(B FMAs a weight at 67 TFLOP/s). A time that halves with int8 follows the
bytes; one that follows B follows the products; one that does neither is
latency. ``matvec_stacked`` at the qkv shape (no RMSNorm prologue) beside
``ln_qkv_stacked`` isolates the prologue. Needs one NVIDIA GPU.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import chip_smoke  # noqa: E402


def main():
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev, L = torch.device("cuda"), args.layers
    E, F, N = 4096, 11008, 12288
    gen = torch.Generator(device=dev).manual_seed(0)
    lids = torch.arange(L, dtype=torch.int32, device=dev)
    ones = torch.ones(L, device=dev)
    norm = torch.ones(L, E, device=dev)

    def weights(K, Nc, int8):
        if int8:
            return torch.randint(-127, 128, (L, K, Nc), generator=gen,
                                 device=dev, dtype=torch.int8)
        return (torch.randn((L, K, Nc), generator=gen, device=dev) * 0.01
                ).to(torch.bfloat16)
    for int8 in (False, True):
        wq, wo = weights(E, N, int8), weights(E, E, int8)
        wg, wu, wd = weights(E, F, int8), weights(E, F, int8), \
            weights(F, E, int8)
        wbytes = 1 if int8 else 2
        for B in (1, 2, 4, 8):
            x = torch.randn(B, E, generator=gen, device=dev).to(torch.bfloat16)
            runs = {
                "ln_qkv_stacked": (lambda i: dk.ln_qkv_stacked(
                    x, norm, None, wq, ones, None, lids[i], norm="rms"),
                    E * N),
                "matvec_stacked[qkv shape]": (lambda i: dk.matvec_stacked(
                    x, wq, ones, lids[i]), E * N),
                "matvec_stacked": (lambda i: dk.matvec_stacked(
                    x, wo, ones, lids[i]), E * E),
                "out_ffn_stacked": (lambda i: dk.out_ffn_stacked(
                    None, x, None, None, None, norm, None, wg, ones, None,
                    wd, ones, None, lids[i], act="swiglu", norm="rms",
                    w1b_stack=wu, s1b=ones, fuse_proj=False), 3 * E * F)}
            for name, (fn, n_w) in runs.items():
                us = chip_smoke.time_graph_ms(fn, n=L) * 1e3
                print(json.dumps({
                    "kernel": name, "weights": "int8" if int8 else "bf16",
                    "B": B, "us": us,
                    "byte_bound_us": (n_w * wbytes + 2 * B * E * 2)
                    / chip_smoke.HBM_BYTES_PER_S * 1e6,
                    "fp32_fma_floor_us": 2 * B * n_w
                    / chip_smoke.FP32_FLOP_PER_S * 1e6,
                    "card": smi}), flush=True)
        del wq, wo, wg, wu, wd
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
