"""Chip smoke for deepspeed_tpu_torch: GPT-2 large paged serving on one
NVIDIA GPU, through the hand-written CUDA kernels.

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
               must reject; with its device time (CUDA-graph replay between CUDA
               events), the time of an eager call (host included), the
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
               forward of the plain versions.

With ``--profile`` a fourth phase serves the same kind of traffic again
under torch.profiler (device time by kernel name, the device's idle
share, the torch ops' host time) and once more under cProfile (the
host's Python by function).

It then prints the nvidia-smi line, a ``kernels`` JSON line and, last,
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
nonzero and the last line is not printed. Without a CUDA device it exits
with code 2 before doing anything.
"""

import cProfile
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
    f_rel = tolerance.row_rel_err(fault, want)
    if not f_rel > tolerance.ROW_RTOL[name]:
        raise AssertionError(f"{name}: a planted fault ({f_rel:.3g}) "
                             f"passes the check")
    return abs_err, rel, f_rel


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


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

    def record(name, replaces, checks, ms, call_ms, plain_ms, bound_ms_by,
               cases, fault, library_ms=None, lse_err=None):
        b_ms, b_by = bound_ms_by
        abs_errs = [c[0] for c in checks] + (
            [] if lse_err is None else [lse_err])
        f_rel = min(c[2] for c in checks if c[2] is not None)
        row = {"name": name, "route": "cuda",
               "source": f"deepspeed_tpu_torch/csrc/"
                         f"{'flash_attention' if 'flash' in name else 'decode'}.cu",
               "replaces": replaces, "launches": 0,
               "max_abs_err": max(abs_errs), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": library_ms}
        results.append(row)
        emit({"phase": "kernel", "name": name, "cases": cases,
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
    record("ln_qkv_stacked", "deepspeed_tpu/ops/pallas/decode.py:496",
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
    record("decode_attention_paged",
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
    record("out_ffn_stacked", "deepspeed_tpu/ops/pallas/decode.py:1000",
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
    record("flash_attention_fwd",
           "deepspeed_tpu/ops/pallas/flash_attention.py:122", checks, ms,
           call_ms, plain_ms,
           bound(4 * H * S * D * 2 + H * S * 4,
                 4 * H * D * S * (S + 1) // 2), cases,
           "the last 64-key tile dropped (S=1024, GQA, not causal)",
           library_ms=lib_ms, lse_err=lse_err)
    torch.cuda.synchronize()
    return results


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
    smi = phase_device()
    cfg = gpt2_large(dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    eng = serving.build_engine(
        "gpt2", cfg, init_params(cfg, seed=0, device="cuda"),
        config={"serving": {"slots": 8, "page_size": 16,
                            "max_pages_per_slot": 64}})
    kernels = kernel_phase(eng, cfg, gen)
    launches = serve_phase(eng, cfg, gen)
    for row in kernels:
        row["launches"] = launches.get(row["name"], 0)
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched")
    if "--profile" in sys.argv[1:]:
        profile_phase(eng, cfg)
    for line in smi:
        print(line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
