"""Chip smoke for deepspeed_tpu_torch: GPT-2 large paged serving and GPT-2
large training on one NVIDIA GPU, through the hand-written CUDA kernels.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device   — the card (nvidia-smi name and power limit), CUDA version,
               and the time to build the kernels from ``csrc/*.cu``;
2. kernels  — each CUDA kernel at the main path's shapes (GPT-2 large
               widths, bf16, layer 17, a scattered page table, one idle
               slot) held against its plain PyTorch version on the card
               at its row-relative limit (``ops/cuda/tolerance.py``),
               beside a planted fault (a dropped page, K tile or weight
               rows, made with the plain version) that the same check
               must reject; with its device time (CUDA-graph replay
               between CUDA events), the time of an eager call (host
               included), the
               plain version's time, the least time the card could take
               (bytes over 3.35 TB/s or bf16 operations over 989 TFLOP/s,
               whichever is larger) and, for flash attention,
               scaled_dot_product_attention's time;
3. serve    — ``serving.build_engine`` with GPT-2 large at full width and
               depth (random weights from seed 0) serving 16 greedy
               requests through 8 slots; every kernel's launch count over
               that run, TTFT, generated tokens/s over the serve's wall
               time, decode-only tokens/s over the ticks' time, and the
               decode step time beside its weight-read floor; a
               teacher-forced check of every request against a dense
               forward of the plain versions;
4. kernel    — the flash kernels at the training shape (B=8, H=20,
               S=1024, D=64, causal): the forward (its planted fault:
               every batch element given element 0's K/V) beside SDPA,
               and the two backward kernels (dk/dv and dq), also at
               S=8192 and not causal, beside a planted fault each (one
               q tile's contribution dropped from dk/dv, one k tile from
               dq) and SDPA's backward as the library time, and both
               together against the whole backward's bound;
5. train    — the serving engine freed, ``initialize`` of GPT-2 large
               (vocab 50304, 36 layers, bf16 compute, fp32 masters, bf16
               grads and exp_avg, AdamW, clipping 1.0, ZeRO stage 3 on one
               rank, chunked loss; remat off) and 2 warm-up + 10 timed
               ``train_batch`` steps on one seeded batch of 8 x 1024:
               step time, tokens/s, model TFLOP/s, MFU against 989
               TFLOP/s, peak memory, every step's loss (finite, falling)
               and the kernels' launches (36 a step each);
6. grad_check — a 2-layer model of the same width: one step's loss and
               gradients through the kernels against the same step
               through the plain versions, every leaf at a row-relative
               limit, and a planted fault (a k tile left out of dq)
               that the limit must reject.

Each path counts its kernels' launches from 0 just before its run: the
serve run for the decode kernels and the prefill forward, the train run
for the flash kernels. Flash forward has a row for each path; each row
of the kernels line is timed and bounded at its path's shapes and
carries that path's launches.

With ``--profile`` the serve is repeated under torch.profiler (device
time by kernel name, the device's idle share, the torch ops' host time)
and cProfile (the host's Python by function), and three train steps
under torch.profiler.

It then prints the nvidia-smi line, a ``kernels`` JSON line and, last,
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
nonzero and the last line is not printed. Without a CUDA device it exits
with code 2 before doing anything.
"""

import cProfile
import dataclasses
import itertools
import json
import pstats
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
LAYER = 17
# teacher-forced check: the plain logit of the engine's token may sit at
# most this many bf16 units in the last place (of the position's top
# logit, 0.0156 for a top logit of 2-4) below the plain maximum. Logits
# are bf16, so a near tie may break the other way by a unit or two; the
# top-2 spacing of these random-weight logits is ~8 units, so a decoder
# that takes the runner-up fails.
TF_ULPS = 3
N_REQUESTS = 16
TRAIN_BATCH, TRAIN_SEQ, TRAIN_VOCAB = 8, 1024, 50304
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# full-width 2-layer gradient check: row-relative limit per leaf, kernels
# against plain versions (both bf16 end to end); measured on an H100
# 9.0e-3 at most (wpe), 6.4e-3 median over the 28 leaves
GRAD_RTOL = 3e-2
# the same check's fp32 losses, relative: measured on an H100 1.2e-5
# (11.07650 against 11.07636)
LOSS_RTOL = 1e-3
# the train profile's kernel groups, by words in the kernel's name
# (first match wins)
TRAIN_KERNEL_GROUPS = (
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_fwd", ("flash_fwd",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("copies and casts", ("copy_kernel", "direct_copy", "cat")),
    ("layer norm", ("layer_norm",)),
    ("reductions", ("reduce_kernel", "softmax", "logsumexp")),
    ("embedding", ("embedding", "index")),
    ("elementwise", ("elementwise",)))


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops):
    """(ms, what bounds it) for the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_graph_ms(fn, n=36, reps=10):
    """Device time of one call: ``fn(0) .. fn(n - 1)`` captured in one
    CUDA graph and replayed ``reps`` times between CUDA events (median),
    so the host's launch cost is not in it. ``fn(i)`` reads layer
    ``i``, so back-to-back calls find the weights cold in L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def time_ms(fn, reps=25, inner=10, warmup=3):
    """Median over ``reps`` CUDA-event windows of ``inner`` eager calls
    each: device time plus whatever the host adds between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def held(name, got, want, fault=None):
    """(max abs error, row-relative error) of a kernel's output against
    its plain version, which must be within the kernel's limit; and the
    row-relative error of ``fault``, a planted fault's output on the
    same inputs, which must be beyond it (or None)."""
    from deepspeed_tpu_torch.ops.cuda import tolerance
    rel = tolerance.check_kernel(name, got, want)
    abs_err = float((got.float() - want.float()).abs().max())
    if fault is None:
        return abs_err, rel, None
    f_rel = tolerance.kernel_err(name, fault, want)
    if not f_rel > tolerance.ROW_RTOL[name]:
        raise AssertionError(f"{name}: a planted fault ({f_rel:.3g}) "
                             f"passes the check")
    return abs_err, rel, f_rel


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def record(results, name, path, replaces, checks, ms, call_ms, plain_ms,
           bound_ms_by, cases, fault, library_ms=None, lse_err=None):
    """Append a kernel's row to ``results`` and print its kernel line.
    ``path`` is the main path ("serve" or "train") whose shapes the row
    was timed and bounded at, and whose run its launches are counted
    in. ``checks``: (max abs error, row-relative error, planted fault's
    row-relative error or None) per case."""
    from deepspeed_tpu_torch.ops.cuda import tolerance
    b_ms, b_by = bound_ms_by
    abs_errs = [c[0] for c in checks] + ([] if lse_err is None else [lse_err])
    f_rel = min(c[2] for c in checks if c[2] is not None)
    results.append({
        "name": name, "path": path, "route": "cuda",
        "source": f"deepspeed_tpu_torch/csrc/"
                  f"{'flash_attention' if 'flash' in name else 'decode'}.cu",
        "replaces": replaces, "launches": 0, "max_abs_err": max(abs_errs),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms})
    emit({"phase": "kernel", "name": name, "path": path, "cases": cases,
          "kernel_us": ms * 1e3, "call_us": call_ms * 1e3,
          "plain_us": plain_ms * 1e3,
          "bound_us": b_ms * 1e3, "bound_by": b_by,
          "library_us": None if library_ms is None else library_ms * 1e3,
          "pct_of_bound": 100.0 * b_ms / ms,
          "max_abs_err": max(abs_errs),
          "row_rel_err": max(c[1] for c in checks),
          "row_rtol": tolerance.ROW_RTOL[name],
          "fault": fault, "fault_row_rel_err": f_rel,
          "lse_abs_err": lse_err})


# ------------------------------------------------------------------ phases

def phase_device():
    from deepspeed_tpu_torch.ops.cuda import builder
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    lib = builder.kernels()
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "kernel_build_s": lib.build_s, "built": lib.built,
            "library": lib.path}
    emit(info)
    return smi


def kernel_phase(eng, cfg, gen):
    """Every kernel at the main path's shapes against its plain version,
    and a planted fault of each against the same check."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import tolerance
    p, ad = eng.adapter.p, eng.adapter
    dev = ad.device
    L, E, H, D, Fd = (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_dim,
                      cfg.n_inner)
    B = eng.spec.slots
    ones, lids = ad._ones, ad._layer_ids
    eps = cfg.layer_norm_epsilon
    cyc = itertools.cycle(range(L))   # stream every layer: L2 stays cold

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
            cfg.dtype)

    def at_layer(*stacks):
        """LAYER's slice of each per-layer stack, as a stack of one."""
        return [t[LAYER:LAYER + 1].clone() for t in stacks]

    results = []

    # -- ln_qkv_stacked: [8, 1280] . [36, 1280, 3840]
    x = rnd(B, E)
    qkv_args = (p["ln1_w"], p["ln1_b"], p["attn_qkvw"], ones, p["attn_qkvb"])
    got = dk.ln_qkv_stacked(x, *qkv_args, lids[LAYER], eps=eps)
    # fault: the last 32 weight rows (one row group of K) left out
    f_args = at_layer(*qkv_args)
    f_args[2][:, -32:] = 0
    checks = [held("ln_qkv_stacked", got,
                   dk.ln_qkv_stacked_plain(x, *qkv_args, LAYER, eps),
                   dk.ln_qkv_stacked_plain(x, *f_args, 0, eps))]
    ms = time_graph_ms(lambda i: dk.ln_qkv_stacked(x, *qkv_args, lids[i],
                                                   eps=eps))
    call_ms = time_ms(lambda: dk.ln_qkv_stacked(x, *qkv_args,
                                                lids[next(cyc)], eps=eps))
    plain_ms = time_ms(lambda: dk.ln_qkv_stacked_plain(
        x, *qkv_args, next(cyc), eps), reps=20, inner=1)
    N = 3 * E
    record(results, "ln_qkv_stacked", "serve",
           "deepspeed_tpu/ops/pallas/decode.py:496",
           checks, ms, call_ms, plain_ms,
           bound(nbytes(x) + E * N * 2 + 2 * E * 4 + N * 4 + B * N * 2,
                 2 * B * E * N), [{"B": B, "E": E, "N": N, "L": L}],
           "the last 32 of the 1280 weight rows dropped")

    # -- decode_attention_paged: scattered pages, one idle slot
    kc, vc = eng.cache.pool
    for t in (kc, vc):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev,
                            dtype=torch.float32).to(t.dtype) * 0.5)
    maxp, page = eng.spec.max_pages_per_slot, eng.spec.page_size
    pos_list = [511, 300, 17, 700, 100, 1000, 64, -1][:B]
    perm = torch.randperm(eng.cache.num_blocks - 1, generator=gen,
                          device=dev) + 1
    pt = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    # fault: each slot's last live page left out
    pos_fault = torch.where(pos >= page, pos // page * page - 1, pos)
    checks, cases = [], []
    for R, rps in ((1, None), (2, 1), (4, 2)):
        q = rnd(B, H, R, D)
        pos_r = pos.clamp(max=maxp * page - R) if R > 1 else pos
        got = dk.decode_attention_paged(q, kc, vc, pos_r, pt, lids[LAYER],
                                        rows_per_step=rps)
        if torch.count_nonzero(got[B - 1]):
            raise AssertionError("idle slot output is not zero")
        fault = dk.decode_attention_paged_plain(
            q, kc, vc, pos_fault, pt, LAYER) if R == 1 else None
        checks.append(held("decode_attention_paged", got,
                           dk.decode_attention_paged_plain(
                               q, kc, vc, pos_r, pt, LAYER,
                               rows_per_step=rps), fault))
        cases.append({"B": B, "H": H, "R": R, "D": D, "page": page,
                      "rows_per_step": rps, "pos": pos_r.tolist()})
    q = rnd(B, H, 1, D)
    ms = time_graph_ms(lambda i: dk.decode_attention_paged(q, kc, vc, pos, pt,
                                                           lids[i]))
    call_ms = time_ms(lambda: dk.decode_attention_paged(q, kc, vc, pos, pt,
                                                        lids[next(cyc)]))
    plain_ms = time_ms(lambda: dk.decode_attention_paged_plain(
        q, kc, vc, pos, pt, next(cyc)), reps=20, inner=1)
    # this run's data: the live K/V rows, q and out, pos, live table rows
    live = sum(pp + 1 for pp in pos_list if pp >= 0)
    pages_read = sum(pp // page + 1 for pp in pos_list if pp >= 0)
    record(results, "decode_attention_paged", "serve",
           "deepspeed_tpu/ops/pallas/decode.py:931", checks, ms, call_ms,
           plain_ms,
           bound(live * H * D * 2 * 2 + 2 * nbytes(q) + nbytes(pos)
                 + pages_read * 4, 4 * live * H * D), cases,
           "each live slot's last page dropped (R=1)")

    # -- out_ffn_stacked: three launches per call
    ctx, x = rnd(B, E), rnd(B, E)
    ffn = (p["attn_ow"], ones, p["attn_ob"], p["ln2_w"], p["ln2_b"],
           p["inter_w"], ones, p["inter_b"], p["output_w"], ones,
           p["output_b"])
    got = dk.out_ffn_stacked(ctx, x, *ffn, lids[LAYER], eps=eps)
    # fault: the last 64 rows of Wp (one K tile of launch (a)) left out
    f_ffn = at_layer(*ffn)
    f_ffn[0][:, -64:] = 0
    checks = [held("out_ffn_stacked", got,
                   dk.out_ffn_stacked_plain(ctx, x, *ffn, LAYER, eps=eps),
                   dk.out_ffn_stacked_plain(ctx, x, *f_ffn, 0, eps=eps))]
    ms = time_graph_ms(lambda i: dk.out_ffn_stacked(ctx, x, *ffn, lids[i],
                                                    eps=eps))
    call_ms = time_ms(lambda: dk.out_ffn_stacked(ctx, x, *ffn,
                                                 lids[next(cyc)], eps=eps))
    plain_ms = time_ms(lambda: dk.out_ffn_stacked_plain(
        ctx, x, *ffn, next(cyc), eps=eps), reps=20, inner=1)
    w_bytes = (E * E + 2 * E * Fd) * 2
    v_bytes = (6 * E + Fd) * 4
    record(results, "out_ffn_stacked", "serve",
           "deepspeed_tpu/ops/pallas/decode.py:1000",
           checks, ms, call_ms, plain_ms,
           bound(w_bytes + v_bytes + 3 * B * E * 2,
                 2 * B * (E * E + 2 * E * Fd)),
           [{"B": B, "E": E, "F": Fd, "launches_per_call": 3}],
           "the last 64 of the 1280 rows of Wp dropped")

    # -- flash_attention_fwd: prefill buckets, long S, GQA
    checks, cases, lse_err = [], [], 0.0
    for S, Hq, Hkv, causal in ((16, H, H, True), (1024, H, H, True),
                               (8192, 4, 4, True), (1024, H, 4, False)):
        q, k, v = rnd(1, Hq, S, D), rnd(1, Hkv, S, D), rnd(1, Hkv, S, D)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        # fault: the last 64-key tile left out (the non-causal case)
        fault = None if causal else fa.flash_attention_fwd_plain(
            q, k[:, :, :-64], v[:, :, :-64])[0]
        checks.append(held("flash_attention_fwd", o, o_ref, fault))
        lse_err = max(lse_err, tolerance.check_lse(lse, lse_ref))
        cases.append({"S": S, "H": Hq, "Hkv": Hkv, "causal": causal})
        del o_ref, lse_ref, fault
    S = 1024
    q, k, v = rnd(1, H, S, D), rnd(1, H, S, D), rnd(1, H, S, D)
    ms = time_graph_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal=True))
    call_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, causal=True), reps=20, inner=1)
    lib_ms = time_graph_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True))
    record(results, "flash_attention_fwd", "serve",
           "deepspeed_tpu/ops/pallas/flash_attention.py:122", checks, ms,
           call_ms, plain_ms,
           bound(4 * H * S * D * 2 + H * S * 4,
                 4 * H * D * S * (S + 1) // 2), cases,
           "the last 64-key tile dropped (S=1024, GQA, not causal)",
           library_ms=lib_ms, lse_err=lse_err)
    torch.cuda.synchronize()
    return results


def train_kernel_phase(gen):
    """The flash kernels at the training shape (B=8, H=20, S=1024,
    causal): the forward, held against its plain version with a planted
    fault and timed beside SDPA; the two backward kernels there, at
    S=8192 and not causal, with a planted fault each, timed beside SDPA's
    backward."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import tolerance
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    results = []
    B, H, S = TRAIN_BATCH, 20, TRAIN_SEQ
    q, k, v = (rnd(B, H, S, 64) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    # fault: every batch element attends to element 0's K/V, as a kernel
    # that left the batch out of its K/V offset would
    fault = fa.flash_attention_fwd_plain(q, k[:1].expand_as(k),
                                         v[:1].expand_as(v), causal=True)[0]
    checks = [held("flash_attention_fwd", o, o_ref, fault)]
    lse_err = tolerance.check_lse(lse, lse_ref)
    del o, lse, o_ref, lse_ref, fault
    ms = time_graph_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal=True))
    call_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, causal=True), reps=10, inner=1)
    lib_ms = time_graph_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True))
    record(results, "flash_attention_fwd", "train",
           "deepspeed_tpu/ops/pallas/flash_attention.py:122", checks, ms,
           call_ms, plain_ms,
           bound(4 * B * H * S * 64 * 2 + B * H * S * 4,
                 4 * B * H * 64 * S * (S + 1) // 2),
           [{"B": B, "S": S, "H": H, "Hkv": H, "causal": True}],
           "every batch element given element 0's K/V", library_ms=lib_ms,
           lse_err=lse_err)
    del q, k, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def inputs(B, H, S, causal):
        q, k, v, do = (rnd(B, H, S, 64) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta = (do.float() * o.float()).sum(-1)
        return q, k, v, do, lse, delta

    dkv_checks, dq_checks, cases = [], [], []
    for B, H, S, causal in ((TRAIN_BATCH, 20, TRAIN_SEQ, True),
                            (1, 4, 8192, True), (1, 20, 1024, False)):
        q, k, v, do, lse, delta = inputs(B, H, S, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        dk_p, dv_p = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse,
                                                      delta, causal)
        dq_p = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                               causal)
        fault_dk = fault_dv = fault_dq = None
        if len(cases) == 0:
            # faults: the last q tile's contribution dropped from dk/dv,
            # the first k tile dropped from dq
            qf, dof = q.clone(), do.clone()
            qf[:, :, -64:] = 0
            dof[:, :, -64:] = 0
            fault_dk, fault_dv = fa.flash_attention_bwd_dkv_plain(
                qf, k, v, dof, lse, delta, causal)
            kf = k.clone()
            kf[:, :, :64] = 0
            fault_dq = fa.flash_attention_bwd_dq_plain(q, kf, v, do, lse,
                                                       delta, causal)
        dkv_checks += [held("flash_attention_bwd_dkv", dk, dk_p, fault_dk),
                       held("flash_attention_bwd_dkv", dv, dv_p, fault_dv)]
        dq_checks.append(held("flash_attention_bwd_dq", dq, dq_p, fault_dq))
        cases.append({"B": B, "H": H, "S": S, "D": 64, "causal": causal})
        del dk_p, dv_p, dq_p, fault_dk, fault_dv, fault_dq
        torch.cuda.empty_cache()

    B, H, S = TRAIN_BATCH, 20, TRAIN_SEQ
    q, k, v, do, lse, delta = inputs(B, H, S, True)
    args = (q, k, v, do, lse, delta, True)
    pairs = B * H * S * (S + 1) // 2             # causal (q, k) pairs
    mm_flops = 2 * pairs * 64                    # one [S, S] x D product
    in_bytes = nbytes(q, k, v, do, lse, delta)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg,
                                                           is_causal=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                 retain_graph=True))
    bwd_rows = []
    for name, fn, plain, checks, n_mm, out_bytes, replaces, fault in (
            ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv,
             fa.flash_attention_bwd_dkv_plain, dkv_checks, 4,
             2 * nbytes(k), "deepspeed_tpu/ops/pallas/flash_attention.py:405",
             "the last 64-query tile's contribution dropped from dk and dv"),
            ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dq_plain, dq_checks, 3, nbytes(q),
             "deepspeed_tpu/ops/pallas/flash_attention.py:367",
             "the first 64-key tile dropped from dq")):
        ms = time_graph_ms(lambda i, fn=fn: fn(*args))
        call_ms = time_ms(lambda fn=fn: fn(*args))
        plain_ms = time_ms(lambda plain=plain: plain(*args), reps=10,
                           inner=1)
        record(bwd_rows, name, "train", replaces, checks, ms, call_ms,
               plain_ms, bound(in_bytes + out_bytes, n_mm * mm_flops), cases,
               fault, library_ms=lib_ms)
    # the whole backward (dq, dk, dv): 5 products of 2·S²·D a head when
    # each score tile is computed once, against SDPA's backward
    whole_ms, whole_by = bound(in_bytes + 3 * nbytes(q), 5 * mm_flops)
    both_ms = sum(row["ms"] for row in bwd_rows)
    emit({"phase": "flash_backward", "B": B, "H": H, "S": S, "causal": True,
          "kernels_us": both_ms * 1e3, "bound_us": whole_ms * 1e3,
          "bound_by": whole_by, "pct_of_bound": 100.0 * whole_ms / both_ms,
          "sdpa_backward_us": lib_ms * 1e3})
    del out, qg, kg, vg
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results + bwd_rows


def train_model_config(n_layer=36):
    """bench.py's GPT-2 large training model (``bench_train_gpt2``), remat
    off: 80 GB holds the activations."""
    from deepspeed_tpu_torch.models.gpt2 import gpt2_large
    return dataclasses.replace(
        gpt2_large(vocab_size=TRAIN_VOCAB, n_positions=TRAIN_SEQ,
                   dtype=torch.bfloat16, loss_chunk=1024), n_layer=n_layer)


def train_ds_config():
    """bench.py's GPT-2 large training config."""
    return {"train_batch_size": TRAIN_BATCH,
            "gradient_accumulation_steps": 1,
            "zero_optimization": {"stage": 3},
            "bf16": {"enabled": True},
            "data_types": {"grad_dtype": "bf16"},
            "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-4, "weight_decay": 0.01,
                                     "moment_dtype": "bf16"}},
            "steps_per_print": 1000}


def train_batch_ids():
    """One seeded batch of token ids, on the card (as a loader with
    pinned memory would hand it over)."""
    ids = np.random.RandomState(0).randint(
        0, TRAIN_VOCAB, size=(TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    return {"input_ids": torch.as_tensor(ids, device="cuda")}


def train_phase(n_layer=36, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS):
    """``initialize`` + ``train_batch`` at GPT-2 large's full width; returns
    (engine, batch, the train run's kernel launches)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.cuda import builder
    cfg = train_model_config(n_layer)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _, _, _ = ds.initialize(config=train_ds_config(),
                                    model=GPT2LMHeadModel(cfg))
    batch = train_batch_ids()
    warm = [engine.train_batch(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    builder.launches.clear()             # count the main path's run only
    t0 = time.perf_counter()
    losses = [engine.train_batch(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(builder.launches)
    losses = [float(x) for x in torch.stack(warm + losses).cpu()]
    timed = losses[warmup:]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"the loss did not fall: {timed}")
    expect = {name: n_layer * steps for name in
              ("flash_attention_fwd", "flash_attention_bwd_dkv",
               "flash_attention_bwd_dq")}
    if launches != expect:
        raise AssertionError(f"train launch counts {launches} != {expect}")
    step_s = wall_s / steps
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = cfg.num_params()
    flops = (6 * n_params + 12 * cfg.n_layer * TRAIN_SEQ * cfg.n_embd) \
        * tokens
    emit({"phase": "train", "model": "gpt2_large", "layers": cfg.n_layer,
          "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "remat": cfg.remat, "steps": steps, "warmup_steps": warmup,
          "init_and_warmup_s": init_s, "step_ms": step_s * 1e3,
          "tokens_per_s": tokens / step_s,
          "model_tflops_per_step": flops / 1e12,
          "model_tflop_per_s": flops / step_s / 1e12,
          "mfu": flops / step_s / BF16_FLOP_PER_S,
          "step_floor_ms": flops / BF16_FLOP_PER_S * 1e3,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_per_step":
              {k: v / steps for k, v in launches.items()},
          "losses": losses})
    return engine, batch, launches


class _PlainFlash(torch.autograd.Function):
    """Flash attention through the kernels' plain versions, forward and
    backward: the grad check's reference. With ``drop_dq_tile`` the
    backward leaves the first 64-key tile out of dq: the grad check's
    planted fault."""

    @staticmethod
    def forward(ctx, q, k, v, causal, drop_dq_tile):
        from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
        o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.drop_dq_tile = causal, drop_dq_tile
        return o

    @staticmethod
    def backward(ctx, do):
        from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                  causal=ctx.causal)
        if ctx.drop_dq_tile:
            kf = k.clone()
            kf[:, :, :64] = 0
            dq = fa.flash_attention_bwd_plain(q, kf, v, o, lse, do,
                                              causal=ctx.causal)[0]
        return dq, dk, dv, None, None


def plain_attention(drop_dq_tile=False):
    """An attention function for ``SelfAttention.attention`` that runs
    ``_PlainFlash``."""
    def attention(q, k, v, causal=False):
        return _PlainFlash.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, drop_dq_tile)
    return attention


def model_loss_and_grads(model, ids, attention=None):
    """(loss, gradients) of one step of ``model`` on ``ids`` (its
    next-token loss, as ``train_batch`` takes it), with every block's
    attention function swapped for ``attention`` (None: the model's
    own, the kernels)."""
    blocks = [block.attn for block in model.h]
    if attention is not None:
        for attn in blocks:
            attn.attention = attention
    try:
        loss = model(ids, labels=ids)
        grads = torch.autograd.grad(loss.float(), list(model.parameters()))
    finally:
        for attn in blocks:
            attn.__dict__.pop("attention", None)
    return float(loss.detach()), grads


def grad_check_phase(n_layer=2):
    """A 2-layer model of GPT-2 large's width, as ``initialize`` holds it
    on the card (bf16 compute copy): one step's gradients through the
    kernels against the same step through their plain versions, every
    leaf at GRAD_RTOL and the losses at LOSS_RTOL; then through a planted
    fault (the first 64-key tile left out of dq), which the same limit
    must reject."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.cuda import tolerance
    engine, _, _, _ = ds.initialize(
        config=train_ds_config(),
        model=gpt2.GPT2LMHeadModel(train_model_config(n_layer)))
    ids = train_batch_ids()["input_ids"]
    model, names = engine.module, engine.param_names
    loss_k, grads_k = model_loss_and_grads(model, ids)
    loss_p, grads_p = model_loss_and_grads(model, ids, plain_attention())
    loss_f, grads_f = model_loss_and_grads(model, ids,
                                           plain_attention(True))

    def errs(grads):
        return {name: tolerance.row_rel_err(g, w, floor=1e-3)
                for name, g, w in zip(names, grads, grads_p)}
    err, f_err = errs(grads_k), errs(grads_f)
    worst = max(err, key=err.get)
    f_worst = max(f_err, key=f_err.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emit({"phase": "grad_check", "layers": n_layer, "leaves": len(err),
          "loss_kernels": loss_k, "loss_plain": loss_p,
          "loss_rel_err": loss_rel, "loss_limit": LOSS_RTOL,
          "max_row_rel_err": err[worst], "worst_leaf": worst,
          "median_row_rel_err": float(np.median(list(err.values()))),
          "limit": GRAD_RTOL,
          "fault": "the first 64-key tile left out of dq (plain versions)",
          "fault_loss": loss_f, "fault_max_row_rel_err": f_err[f_worst],
          "fault_worst_leaf": f_worst,
          "fault_leaves_rejected": sum(e > GRAD_RTOL
                                       for e in f_err.values())})
    if not err[worst] <= GRAD_RTOL:
        raise AssertionError(f"grad check: {worst} row-relative error "
                             f"{err[worst]:.3g} > {GRAD_RTOL}")
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"grad check: loss {loss_k} vs plain {loss_p} "
                             f"({loss_rel:.3g} > {LOSS_RTOL})")
    if not f_err[f_worst] > GRAD_RTOL:
        raise AssertionError(f"grad check: a planted fault "
                             f"({f_err[f_worst]:.3g}) passes the check")


def train_profile_phase(engine, batch, steps=3):
    """``--profile``: ``steps`` train steps under torch.profiler: device
    time by kernel name and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.train_batch(batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:20]
    groups = {}
    for e in kernels:
        key = e.key.lower()
        group = next((g for g, words in TRAIN_KERNEL_GROUPS
                      if any(w in key for w in words)), "other")
        groups[group] = groups.get(group, 0.0) + e.device_time_total
    emit({"phase": "train_profile", "steps": steps, "wall_s": wall_s,
          "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
          "groups_ms_per_step": {g: us / 1e3 / steps for g, us in
                                 sorted(groups.items(),
                                        key=lambda kv: -kv[1])},
          "kernels": [{"name": e.key[:90], "count": e.count,
                       "device_ms_per_step": e.device_time_total / 1e3
                       / steps,
                       "share_of_busy": e.device_time_total / busy_us}
                      for e in top]})


def traffic(cfg, rs):
    """The main path's requests: N_REQUESTS greedy requests, prompts of
    32-768 tokens, 16-64 new tokens, drawn from ``rs``."""
    import deepspeed_tpu_torch.serving as serving
    return [serving.Request(i, rs.randint(0, cfg.vocab_size,
                                          rs.randint(32, 769)),
                            max_new_tokens=int(rs.randint(16, 65)))
            for i in range(N_REQUESTS)]


def serve_phase(eng, cfg, gen):
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.models.gpt2_inference import dense_logits
    from deepspeed_tpu_torch.ops.cuda import builder
    rs = np.random.RandomState(0)
    # warm-up (cuBLAS handles, allocator) on a throwaway batcher
    eng.serve([serving.Request("warm", rs.randint(0, cfg.vocab_size, 40),
                               max_new_tokens=4)])
    main = serving.ContinuousBatcher(eng.adapter)
    reqs = traffic(cfg, rs)
    torch.cuda.synchronize()
    builder.launches.clear()             # count the main path's run only
    t0 = time.perf_counter()
    res = main.serve(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(builder.launches)
    st = main.stats
    L = cfg.n_layer
    expect = {"flash_attention_fwd": L * st["prefills"],
              "ln_qkv_stacked": L * st["tick_steps"],
              "decode_attention_paged": L * st["tick_steps"],
              "out_ffn_stacked": L * st["tick_steps"]}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    if len(res) != N_REQUESTS or any(
            len(r.generated) != r.max_new_tokens for r in res.values()):
        raise AssertionError("a request did not finish its budget")
    for r in res.values():
        g = np.asarray(r.generated)
        if g.min() < 0 or g.max() >= cfg.vocab_size:
            raise AssertionError("token outside the vocabulary")
    if not (main.last_logits.shape == (eng.spec.slots, cfg.vocab_size)
            and torch.isfinite(main.last_logits).all()):
        raise AssertionError("tick logits are not finite [slots, vocab]")
    snap = main.metrics_snapshot()
    tick_s = snap["tick_latency_s"]["sum"]
    ms_per_step = tick_s / st["tick_steps"] * 1e3
    w_layers = L * (12 * cfg.n_embd ** 2) * 2          # bf16 layer weights
    w_head = cfg.vocab_size * cfg.n_embd * 2
    floor_ms = (w_layers + w_head) / HBM_BYTES_PER_S * 1e3
    # teacher-forced check: every request's tokens against a dense
    # forward of the plain versions, at every generated position. The
    # planted fault is a decoder that takes the plain runner-up token
    # everywhere: it must fail at some position.
    gaps, spacings, ulps = [], [], []
    for rid in sorted(res):
        r = res[rid]
        toks = r.tokens()
        S = len(r.prompt)
        rows = dense_logits(eng.adapter.p, cfg, toks[:-1])[S - 1:]
        gen_tok = torch.as_tensor(toks[S:], device=rows.device).long()
        top2 = rows.topk(2, dim=-1).values
        gaps.append(top2[:, 0] - rows.gather(1, gen_tok[:, None])[:, 0])
        spacings.append(top2[:, 0] - top2[:, 1])
        # bf16 keeps 8 significant bits: a unit is 2**(exponent - 7)
        ulps.append(torch.exp2(torch.floor(torch.log2(
            top2[:, 0].abs().clamp_min(1e-30))) - 7))
    gap, spacing, ulp = torch.cat(gaps), torch.cat(spacings), torch.cat(ulps)
    worst = float(gap.max())
    worst_ulps = float((gap / ulp).max())
    n_fault_caught = int((spacing > TF_ULPS * ulp).sum())
    if worst_ulps > TF_ULPS:
        raise AssertionError(f"teacher-forced logit gap {worst} is "
                             f"{worst_ulps} bf16 units > {TF_ULPS}")
    if n_fault_caught == 0:
        raise AssertionError("a runner-up decoder passes the teacher-forced "
                             "check")
    generated = sum(len(r.generated) for r in res.values())
    emit({"phase": "serve", "model": "gpt2_large", "layers": L,
          "requests": N_REQUESTS, "slots": eng.spec.slots,
          "prefills": st["prefills"], "prefill_tokens": st["prefill_tokens"],
          "decode_tokens": st["decode_tokens"], "ticks": st["ticks"],
          "tick_steps": st["tick_steps"], "wall_s": wall_s,
          "ttft_p50_s": snap["ttft_s"]["p50"],
          "ttft_p99_s": snap["ttft_s"]["p99"],
          "generated_tokens": generated,
          "tokens_per_s_wall": generated / wall_s,
          # decode steps only: the ticks' time, without prefill/admission
          "decode_only_tokens_per_s": st["decode_tokens"] / tick_s,
          "ms_per_decode_step": ms_per_step,
          "decode_step_floor_ms": floor_ms,
          "page_pool_occupancy_hwm": snap["page_pool"]["occupancy_hwm"],
          "launches": launches,
          "teacher_forced_requests": len(res),
          "teacher_forced_positions": len(spacing),
          "teacher_forced_gap_limit_ulps": TF_ULPS,
          "teacher_forced_max_logit_gap": worst,
          "teacher_forced_max_gap_ulps": worst_ulps,
          "teacher_forced_not_plain_argmax": int((gap > 0).sum()),
          "plain_top2_spacing_median": float(spacing.median()),
          "runner_up_fault_rejected_at": n_fault_caught})
    return launches


def profile_phase(eng, cfg, reqs_seed=1):
    """``--profile``: the same traffic served twice more. Once under
    torch.profiler: device time by kernel name, the device's busy share
    of the window (kernels run on one stream, so their times add) and
    the torch ops' host time. Once under cProfile: the host's Python,
    function by function."""
    import deepspeed_tpu_torch.serving as serving
    from torch.profiler import ProfilerActivity, profile
    main = serving.ContinuousBatcher(eng.adapter)
    reqs = traffic(cfg, np.random.RandomState(reqs_seed))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        main.serve(reqs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host_ops = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CPU]
    busy_us = sum(e.device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:16]
    top_host = sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:12]
    emit({"phase": "profile", "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
          "prefills": main.stats["prefills"],
          "tick_steps": main.stats["tick_steps"],
          "kernels": [{"name": e.key[:90], "count": e.count,
                       "device_ms": e.device_time_total / 1e3}
                      for e in top],
          "host_ops": [{"name": e.key[:60], "count": e.count,
                        "self_cpu_ms": e.self_cpu_time_total / 1e3}
                       for e in top_host]})

    main = serving.ContinuousBatcher(eng.adapter)
    reqs = traffic(cfg, np.random.RandomState(reqs_seed))
    prof_py = cProfile.Profile()
    t0 = time.perf_counter()
    prof_py.runcall(main.serve, reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    rows = sorted(pstats.Stats(prof_py).stats.items(),
                  key=lambda kv: -kv[1][2])[:15]
    emit({"phase": "host_profile", "wall_s": wall_s,
          "tick_steps": main.stats["tick_steps"],
          "functions": [{"name": f"{fn[0].split('/')[-1]}:{fn[1]}:{fn[2]}",
                         "calls": st[1], "tottime_ms": st[2] * 1e3,
                         "cumtime_ms": st[3] * 1e3}
                        for fn, st in rows]})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.models.gpt2 import gpt2_large, init_params
    profile = "--profile" in sys.argv[1:]
    smi = phase_device()
    cfg = gpt2_large(dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    eng = serving.build_engine(
        "gpt2", cfg, init_params(cfg, seed=0, device="cuda"),
        config={"serving": {"slots": 8, "page_size": 16,
                            "max_pages_per_slot": 64}})
    kernels = kernel_phase(eng, cfg, gen)
    launches = serve_phase(eng, cfg, gen)
    if profile:
        profile_phase(eng, cfg)
    del eng                       # free the serving engine for training
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels += train_kernel_phase(gen)
    engine, batch, train_launches = train_phase()
    if profile:
        train_profile_phase(engine, batch)
    del engine, batch
    torch.cuda.empty_cache()
    grad_check_phase()
    for row in kernels:
        ran = train_launches if row["path"] == "train" else launches
        row["launches"] = ran.get(row["name"], 0)
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched on the "
                                 f"{row['path']} path")
    for line in smi:
        print(line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
