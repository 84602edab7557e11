"""Device times of the flash forward, the flash backward and
matvec_stacked at the shapes of their kernel-table rows (PERF.md §6),
beside their library calls, on one card: CUDA-graph replay as
chip_smoke.py times them, random bf16 inputs from seed 0.

    python3 tests/perf/torch_kernel_rows.py [--bwd] [--decode] [--bs]
        [--tree DIR]

(--bwd: the backward rows only; --decode, --bs: only the decode rows
(projections and attention) or the block-sparse rows; --tree DIR: the
kernels of the checkout at DIR, for an A/B against another commit in one
call.)

Flash forward: GPT-2 prefill (B 1, 20 heads, S 1024, D 64), GPT-2
training (B 8), a ZeRO-3 rank (B 2), LLaMA-7B prefill (32 heads, D 128),
the fast path's prompt pass (B 8, S 2048, D 128) and the long-S row (4
heads, S 8192, D 64), all causal: the kernel (``us``; ``turns``: whether
its warpgroups take turns), the other turn setting (``other_turns_us``),
SDPA (``sdpa_us``).
Flash backward: GPT-2 training (B 8, 20 heads, S 1024, D 64), a ZeRO-3
rank (B 2), the long-S row (4 heads, S 8192), GPT-2 not causal (B 1) and
LLaMA-7B's training attention (B 2, 32 heads, S 2048, D 128): the
single-pass kernel (``us``), the delta kernel (``delta_us``), the eager
delta expression it replaces (``delta_expression_us``), the whole
backward (``whole_us``: delta + kernel, as a training step runs it), the
bound of its 5 products and bytes, and SDPA's backward (``sdpa_us``:
forward + backward in one graph, less the forward).
matvec_stacked: LLaMA-7B's o-projection [8, 4096] . [32, 4096, 4096],
bf16 and int8 codes: the TMA kernel (``us``), the CUDA-core kernel
(``fma_us``) and, bf16, torch.matmul (``matmul_us``). Decode projections
(--decode): see proj_rows. Decode attention (--decode):
decode_attention_stacked over bf16 and int8 caches at GPT-2
large's fast route (20 heads, D 64) and LLaMA-7B's (32 heads, D 128), b1
and b8, ctx 2048, pos 2034, with SDPA over the live keys (bf16), and
decode_attention_paged over bf16 and int8 pools at 8 slots of 64 pages of
16 (the serve phase's positions); each with the kernel's split plan.
Block-sparse (--bs): the forward, dq and dk/dv at BERT-large's layer (B
4, H 16, S 4096, D 64) under DeepSpeed's Fixed layout at block 16 and a
shared BigBird layout at block 64, beside SDPA over the expanded layout,
with each work list's summary. One JSON line a row, each with the card's
name and power limit.

    python3 tests/perf/torch_kernel_rows.py --sweep

adds what separates a launch's fixed cost from its streaming cost:
matvec_stacked over K 1024-8192 at N 4096 (bf16 and int8), and the flash
forward over non-causal launches of ~1320 blocks whose blocks take 1, 2,
4 or 8 key tiles (S 128 t, D 64 and 128).
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
if "--tree" in sys.argv:    # the kernels of another checkout, same rows
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--tree")
                                                + 1]))

from chip_smoke import bert_model_config, bound, time_graph_ms  # noqa: E402
from deepspeed_tpu_torch.ops.cuda import blocksparse as bs  # noqa: E402
from deepspeed_tpu_torch.ops.cuda import decode as dk  # noqa: E402
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

FLASH_ROWS = (("gpt2_prefill", 1, 20, 1024, 64, 36),
              ("gpt2_train", 8, 20, 1024, 64, 36),
              ("zero3_rank", 2, 20, 1024, 64, 36),
              ("llama7b_prefill", 1, 32, 1024, 128, 32),
              ("fast_path_prompt", 8, 32, 2048, 128, 8),
              ("long_s", 1, 4, 8192, 64, 8))
# (name, B, H, S, D, causal, graph length)
BWD_ROWS = (("gpt2_train", 8, 20, 1024, 64, True, 8),
            ("zero3_rank", 2, 20, 1024, 64, True, 8),
            ("long_s", 1, 4, 8192, 64, True, 4),
            ("gpt2_not_causal", 1, 20, 1024, 64, False, 8),
            ("llama7b_train", 2, 32, 2048, 128, True, 4))


def bwd_rows(card, rnd):
    """One JSON line a backward row (see the module's docstring)."""
    for name, B, H, S, D, causal, n in BWD_ROWS:
        q, k, v, do = (rnd(B, H, S, D) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta = fa.flash_attention_bwd_delta_plain(o, do)
        args = (q, k, v, do, lse, delta, causal)
        us = 1e3 * time_graph_ms(
            lambda i: fa.flash_attention_bwd_kernel(*args), n=n)
        delta_us = 1e3 * time_graph_ms(
            lambda i: fa.flash_attention_bwd_delta(o, do), n=n)
        expr_us = 1e3 * time_graph_ms(
            lambda i: fa.flash_attention_bwd_delta_plain(o, do), n=n)
        whole_us = 1e3 * time_graph_ms(
            lambda i: fa.flash_attention_bwd(q, k, v, o, lse, do, causal),
            n=n)
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, is_causal=causal)
        sdpa_us = 1e3 * (time_graph_ms(
            lambda i: torch.autograd.grad(sdpa(), (qg, kg, vg), do), n=n)
            - time_graph_ms(lambda i: sdpa(), n=n))
        pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
        b_ms, b_by = bound(8 * q.numel() + 2 * lse.numel() * 4
                           + 6 * q.numel(), 5 * 2 * pairs * D)
        print(json.dumps({"row": f"flash_attention_bwd {name}", "B": B,
                          "H": H, "S": S, "D": D, "causal": causal,
                          "us": us, "delta_us": delta_us,
                          "delta_expression_us": expr_us,
                          "whole_us": whole_us, "sdpa_us": sdpa_us,
                          "bound_us": b_ms * 1e3, "bound_by": b_by,
                          "pct_of_bound": 100 * b_ms * 1e3 / us,
                          "card": card}), flush=True)
        del q, k, v, do, o, lse, delta, qg, kg, vg


# (name, B, KV heads, R, D, cache length, pos, layers): the stacked rows
# of PERF.md §6 (#10, #11): GPT-2 large's fast route at b1 and LLaMA-7B's
# fast path at b8, ctx 2048, pos 2034
STACKED_ROWS = (("gpt2_b1", 1, 20, 1, 64, 2048, 2034, 36),
                ("gpt2_b8", 8, 20, 1, 64, 2048, 2034, 36),
                ("llama7b_b1", 1, 32, 1, 128, 2048, 2034, 32),
                ("llama7b_b8", 8, 32, 1, 128, 2048, 2034, 32))
# (name, KV heads, D, layers): the paged rows (#3): 8 slots, 64 pages of
# 16, the serve phase's positions (one slot idle)
PAGED_ROWS = (("gpt2_serve", 20, 64, 36), ("llama7b_serve", 32, 128, 32))
PAGED_POS = [511, 300, 17, 700, 100, 1000, 64, -1]


def _plan(B, H, cap):
    """The split plan, where the tree has one (the kernel before it had
    none: one block a (head, slot))."""
    plan = getattr(dk, "decode_split_plan", None)
    if plan is None:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return plan(B, H, cap, sms)._asdict()


def decode_rows(card, rnd, gen):
    """decode_attention_stacked (bf16 and int8 caches) and
    decode_attention_paged (bf16 and int8 pools) at their table rows:
    the kernel, SDPA over the live keys where it computes the same
    function (bf16, R 1), the bound of the live rows' bytes."""
    for name, B, H, R, D, L, p, n in STACKED_ROWS:
        q = rnd(B, H, R, D)
        pos = torch.tensor([p], dtype=torch.int32, device="cuda")
        lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
                for i in range(n)]
        for kind in ("bf16", "int8"):
            shape = (n, B, H, L, D)
            kw = {}
            if kind == "bf16":
                kc, vc = rnd(*shape), rnd(*shape)
            else:
                kc, vc = (torch.randint(-127, 128, shape, generator=gen,
                                        device="cuda", dtype=torch.int8)
                          for _ in range(2))
                kw = {k: torch.rand(shape[:3] + (1, L), generator=gen,
                                    device="cuda") * 0.01 + 0.002
                      for k in ("k_scale", "v_scale")}
            us = 1e3 * time_graph_ms(lambda i: dk.decode_attention_stacked(
                q, kc, vc, pos, lids[i], **kw), n=n)
            sdpa = None
            if kind == "bf16":
                qs = q.reshape(B, H * R, 1, D)
                sdpa = 1e3 * time_graph_ms(
                    lambda i: torch.nn.functional.scaled_dot_product_attention(
                        qs, kc[i, :, :, :p + 1], vc[i, :, :, :p + 1]), n=n)
            row = D * kc.element_size() + (4 if kw else 0)
            b_ms, b_by = bound(B * (p + 1) * H * row * 2 + 2 * q.numel() * 2,
                               4 * B * (p + 1) * H * R * D)
            print(json.dumps({"row": f"decode_attention_stacked {name}",
                              "cache": kind, "B": B, "H": H, "R": R, "D": D,
                              "L": L, "pos": p, "us": us, "sdpa_us": sdpa,
                              "bound_us": b_ms * 1e3, "bound_by": b_by,
                              "pct_of_bound": 100 * b_ms * 1e3 / us,
                              "plan": _plan(B, H, L), "card": card}),
                  flush=True)
            del kc, vc, kw
    B, page, maxp = len(PAGED_POS), 16, 64
    pos = torch.tensor(PAGED_POS, dtype=torch.int32, device="cuda")
    live = sum(x + 1 for x in PAGED_POS if x >= 0)
    for name, H, D, n in PAGED_ROWS:
        NB = B * maxp + 1
        pt = (torch.randperm(NB - 1, generator=gen, device="cuda")[:B * maxp]
              + 1).reshape(B, maxp).to(torch.int32)
        q = rnd(B, H, 1, D)
        lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
                for i in range(n)]
        for kind in ("bf16", "int8"):
            shape = (n, NB, H, page, D)
            kw = {}
            if kind == "bf16":
                kc, vc = rnd(*shape), rnd(*shape)
            else:
                kc, vc = (torch.randint(-127, 128, shape, generator=gen,
                                        device="cuda", dtype=torch.int8)
                          for _ in range(2))
                kw = {k: torch.rand(shape[:3] + (1, page), generator=gen,
                                    device="cuda") * 0.01 + 0.002
                      for k in ("k_scale", "v_scale")}
            us = 1e3 * time_graph_ms(lambda i: dk.decode_attention_paged(
                q, kc, vc, pos, pt, lids[i], **kw), n=n)
            row = D * kc.element_size() + (4 if kw else 0)
            b_ms, b_by = bound(live * H * row * 2 + 2 * q.numel() * 2,
                               4 * live * H * D)
            print(json.dumps({"row": f"decode_attention_paged {name}",
                              "pool": kind, "B": B, "H": H, "D": D,
                              "pos": PAGED_POS, "us": us,
                              "bound_us": b_ms * 1e3, "bound_by": b_by,
                              "pct_of_bound": 100 * b_ms * 1e3 / us,
                              "plan": _plan(B, H, maxp * page),
                              "card": card}), flush=True)
            del kc, vc, kw


def _weights(rnd, gen, kind, *shape):
    """Random bf16 weights (std 0.0112) or int8 codes of ``shape``."""
    if kind == "bf16":
        return rnd(*shape) * 0.0112
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def _proj_plans(B, wb, launches):
    """Each launch's plan (K, N, prologue[, pair]) where the
    tree has the projection template (the CUDA-core kernel before it had
    none)."""
    if not hasattr(dk, "proj_smem"):
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return [dk.matvec_tma_plan(B, K, N, wb, sms, *rest)._asdict()
            for K, N, *rest in launches]


def proj_rows(card, rnd, gen):
    """The decode projections at their table rows: LLaMA-7B's
    ln_qkv_stacked ([B, 4096] . [32, 4096, 12288], RMSNorm) and
    out_ffn_stacked (SwiGLU, F 11008, two launches) at 1, 8 and 16 slots,
    bf16 and int8 codes, with torch.matmul of the bare projection(s) as a
    yardstick of the weight stream (bf16); GPT-2 large's ln_qkv_stacked
    and out_ffn_stacked (LayerNorm, biases, three launches) at B 1 and 8,
    bf16 and int8, its per-token ln_qkv_int8 / out_ffn_int8 and
    matvec_int8 (gelu_tanh) at B 8, and matvec_stacked at LLaMA-7B's
    o-projection at B 1 and 8; each with its bound and launch plan. A launch the tree
    refuses prints its error."""
    def emit(row, us, b, **more):
        b_ms, b_by = b
        print(json.dumps({"row": row, "us": us, "bound_us": b_ms * 1e3,
                          "bound_by": b_by,
                          "pct_of_bound": None if us is None
                          else 100 * b_ms * 1e3 / us, **more,
                          "card": card}), flush=True)

    def timed(fn, n):
        try:
            return 1e3 * time_graph_ms(fn, n=n), None
        except ValueError as e:
            return None, str(e)

    L, E, N, F = 32, 4096, 12288, 11008
    lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(36)]
    s = torch.rand(36, generator=gen, device="cuda") * 0.002 + 0.001
    ln = 1 + 0.1 * torch.randn(L, E, generator=gen, device="cuda")
    for kind in ("bf16", "int8"):
        wb = 2 if kind == "bf16" else 1
        wq = _weights(rnd, gen, kind, L, E, N)
        for B in (1, 8, 16):
            x = rnd(B, E)
            us, err = timed(lambda i: dk.ln_qkv_stacked(
                x, ln, None, wq, s[:L], None, lids[i], eps=1e-6,
                norm="rms"), L)
            mm = None if kind == "int8" else 1e3 * time_graph_ms(
                lambda i: torch.matmul(x, wq[i]), n=L)
            emit(f"ln_qkv_stacked llama7b {kind}", us,
                 bound(B * E * 2 + E * N * wb + 4 + E * 4 + B * N * 2,
                       2 * B * E * N), B=B, matmul_us=mm, error=err,
                 plan=_proj_plans(B, wb, [(E, N, "rms_bf16")]))
        del wq
        wg, wu = (_weights(rnd, gen, kind, L, E, F) for _ in range(2))
        wd = _weights(rnd, gen, kind, L, F, E)
        for B in (1, 8, 16):
            x, h = rnd(B, E), rnd(B, F)
            ffn = (None, None, None, ln, None, wg, s[:L], None, wd, s[:L],
                   None)
            us, err = timed(lambda i: dk.out_ffn_stacked(
                None, x, *ffn, lids[i], act="swiglu", eps=1e-6, norm="rms",
                w1b_stack=wu, s1b=s[:L], fuse_proj=False), L)
            mm = None if kind == "int8" else 1e3 * time_graph_ms(
                lambda i: (torch.matmul(x, wg[i]), torch.matmul(x, wu[i]),
                           torch.matmul(h, wd[i])), n=L)
            pair = getattr(dk, "GLU_PAIRING", {}).get(wb)
            emit(f"out_ffn_stacked llama7b {kind}", us,
                 bound(3 * E * F * wb + 3 * 4 + E * 4 + 2 * B * E * 2,
                       6 * B * E * F), B=B, matmul_us=mm, error=err,
                 plan=_proj_plans(B, wb, [(E, F, "rms_bf16", pair),
                                          (F, E, "copy")]))
        del wg, wu, wd
        wo = _weights(rnd, gen, kind, L, E, E)
        for B in (1, 8):
            x = rnd(B, E)
            us, err = timed(lambda i: dk.matvec_stacked(x, wo, s[:L],
                                                        lids[i]), L)
            emit(f"matvec_stacked llama7b {kind}", us,
                 bound(B * E * 2 + E * E * wb + 4 + B * E * 2,
                       2 * B * E * E),
                 B=B, error=err, plan=_proj_plans(B, wb, [(E, E, "copy")]))
        del wo
        torch.cuda.empty_cache()
    L, E, F = 36, 1280, 5120
    N = 3 * E
    f32 = {k: torch.randn(L, n, generator=gen, device="cuda") * 0.1
           for k, n in (("ln_b", E), ("bq", N), ("bp", E), ("ln2_b", E),
                        ("b1", F), ("b2", E))}
    lw = 1 + 0.1 * torch.randn(L, E, generator=gen, device="cuda")
    for kind in ("bf16", "int8"):
        wb = 2 if kind == "bf16" else 1
        wq, wp = (_weights(rnd, gen, kind, L, E, n) for n in (N, E))
        w1, w2 = _weights(rnd, gen, kind, L, E, F), _weights(rnd, gen, kind,
                                                             L, F, E)
        ffn = (wp, s, f32["bp"], lw, f32["ln2_b"], w1, s, f32["b1"], w2, s,
               f32["b2"])
        for B in (1, 8):
            x, ctx = rnd(B, E), rnd(B, E)
            us, err = timed(lambda i: dk.ln_qkv_stacked(
                x, lw, f32["ln_b"], wq, s, f32["bq"], lids[i]), L)
            emit(f"ln_qkv_stacked gpt2 {kind}", us,
                 bound(B * E * 2 + E * N * wb + 4 + 2 * E * 4 + N * 4
                       + B * N * 2, 2 * B * E * N), B=B, error=err,
                 plan=_proj_plans(B, wb, [(E, N, "ln_bf16")]))
            us, err = timed(lambda i: dk.out_ffn_stacked(ctx, x, *ffn,
                                                         lids[i]), L)
            emit(f"out_ffn_stacked gpt2 {kind}", us,
                 bound((E * E + 2 * E * F) * wb + 12 + (6 * E + F) * 4
                       + 3 * B * E * 2, 2 * B * (E * E + 2 * E * F)),
                 B=B, error=err,
                 plan=_proj_plans(B, wb, [(E, E, "copy"),
                                          (E, F, "ln_f32"),
                                          (F, E, "copy")]))
        if kind == "int8":
            B = 8
            x, ctx = rnd(B, E), rnd(B, E)
            one = {k: t[0] for k, t in f32.items()}
            us, err = timed(lambda i: dk.ln_qkv_int8(
                x, lw[i], one["ln_b"], wq[i], s[i:i + 1], one["bq"]), L)
            emit("ln_qkv_int8 gpt2", us,
                 bound(B * E * 2 + E * N + 4 + 2 * E * 4 + N * 4
                       + B * N * 2, 2 * B * E * N), B=B, error=err)
            us, err = timed(lambda i: dk.out_ffn_int8(
                ctx, x, wp[i], s[i:i + 1], one["bp"], lw[i], one["ln2_b"],
                w1[i], s[i:i + 1], one["b1"], w2[i], s[i:i + 1],
                one["b2"]), L)
            emit("out_ffn_int8 gpt2", us,
                 bound((E * E + 2 * E * F) + 12 + (6 * E + F) * 4
                       + 3 * B * E * 2, 2 * B * (E * E + 2 * E * F)),
                 B=B, error=err)
            us, err = timed(lambda i: dk.matvec_int8(
                x, w1[i], s[i:i + 1], one["b1"], act="gelu_tanh"), L)
            emit("matvec_int8 gpt2", us,
                 bound(B * E * 2 + E * F + 4 + F * 4 + B * F * 2,
                       2 * B * E * F), B=B, error=err,
                 plan=_proj_plans(B, 1, [(E, F, "copy")]))
        del wq, wp, w1, w2, ffn
        torch.cuda.empty_cache()


def bs_rows(card, rnd):
    """The block-sparse kernels at BERT-large's sparse attention (B 4, H
    16, S 4096, D 64, DeepSpeed's Fixed layout at block 16) and at the
    shared BigBird layout at block 64: blocksparse_fwd, blocksparse_bwd_dq
    and blocksparse_bwd_dkv, each beside the bound of its products (2, 3
    and 4 products of 2 block^2 D flops a listed block pair: 4, 6 and 8
    block^2 D) and bytes, its plain version (eager), SDPA over the layout
    expanded to a boolean mask (eager, as chip_smoke.py times it: the
    forward beside the forward, forward + backward beside each backward
    pass) and its work list's summary (None on a tree without one)."""
    from chip_smoke import time_ms
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import _expand_layout_mask
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
        BigBirdSparsityConfig
    B, H, S, D = 4, 16, 4096, 64
    sparsity = bert_model_config().sparsity_config
    np.random.seed(0)
    layouts = (("fixed_b16", sparsity.make_layout(S), sparsity.block),
               ("bigbird_b64", BigBirdSparsityConfig(
                   num_heads=H, block=64, num_random_blocks=1,
                   num_sliding_window_blocks=3, num_global_blocks=1)
                .make_layout(S), 64))
    for name, layout, block in layouts:
        tables = bs.layout_tables(layout, S, block, H, "cuda")
        q, k, v, do = (rnd(B * H, S, D) for _ in range(4))
        o, lse = bs.blocksparse_fwd(q, k, v, tables)
        delta = (do.float() * o).sum(-1)
        args = (q, k, v, do, lse, delta, tables)
        active = B * int(np.asarray(layout)[:, :S // block, :S // block]
                         .sum()) * (H // np.asarray(layout).shape[0])
        pair = block * block * D
        bf, f32 = q.numel() * 2, lse.numel() * 4
        mask = _expand_layout_mask(layout, block, S, "cuda")[None]
        q4, k4, v4, do4 = (t.view(B, H, S, D) for t in (q, k, v, do))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        fwd_ms = time_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask), reps=5,
                         inner=2)
        qg, kg, vg = (t.detach().clone().requires_grad_()
                      for t in (q4, k4, v4))
        out = sdpa(qg, kg, vg, attn_mask=mask)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do4, retain_graph=True), reps=5, inner=2)
        for kernel, fn, plain, flops, nbytes_, work, lib_ms in (
                ("blocksparse_fwd", lambda: bs.blocksparse_fwd(q, k, v, tables),
                 lambda: bs.blocksparse_fwd_plain(q, k, v, tables),
                 4 * pair * active, 3 * bf + 2 * bf + f32, "row_work",
                 fwd_ms),
                ("blocksparse_bwd_dq", lambda: bs.blocksparse_bwd_dq(*args),
                 lambda: bs.blocksparse_bwd_dq_plain(*args),
                 6 * pair * active, 5 * bf + 2 * f32, "row_work",
                 fwd_ms + bwd_ms),
                ("blocksparse_bwd_dkv", lambda: bs.blocksparse_bwd_dkv(*args),
                 lambda: bs.blocksparse_bwd_dkv_plain(*args),
                 8 * pair * active, 4 * bf + 2 * f32 + 4 * bf, "dkv_work",
                 fwd_ms + bwd_ms)):
            us = 1e3 * time_graph_ms(lambda i, fn=fn: fn(), n=8, reps=5)
            b_ms, b_by = bound(nbytes_, flops)
            summary = getattr(tables, work)().summary() \
                if hasattr(tables, work) else None
            plain_us = 1e3 * time_ms(plain, reps=2, inner=1, warmup=1)
            print(json.dumps({"row": f"{kernel} {name}", "B": B, "H": H,
                              "S": S, "D": D, "block": block, "us": us,
                              "bound_us": b_ms * 1e3, "bound_by": b_by,
                              "pct_of_bound": 100 * b_ms * 1e3 / us,
                              "plain_us": plain_us,
                              "sdpa_us": 1e3 * lib_ms,
                              "work": summary, "card": card}), flush=True)
        del q, k, v, do, o, lse, delta, args, mask, out, qg, kg, vg


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    if "--decode" in sys.argv or "--bs" in sys.argv:
        if "--decode" in sys.argv:
            proj_rows(card, rnd, gen)
            decode_rows(card, rnd, gen)
        if "--bs" in sys.argv:
            bs_rows(card, rnd)
        return
    bwd_rows(card, rnd)
    if "--bwd" in sys.argv:
        return
    for name, B, H, S, D, n in FLASH_ROWS:
        q, k, v = rnd(B, H, S, D), rnd(B, H, S, D), rnd(B, H, S, D)

        def call(i=0):
            return fa.flash_attention_fwd(q, k, v, causal=True)
        us = 1e3 * time_graph_ms(call, n=n)
        keep = dict(fa.PINGPONG)
        fa.PINGPONG = {**keep, D: not keep[D]}
        try:
            other = 1e3 * time_graph_ms(call, n=n)
        finally:
            fa.PINGPONG = keep
        sdpa = 1e3 * time_graph_ms(
            lambda i: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True), n=n)
        b_ms, _ = bound(4 * B * H * S * D * 2 + B * H * S * 4,
                        4 * B * H * D * S * (S + 1) // 2)
        print(json.dumps({"row": f"flash_attention_fwd {name}", "B": B,
                          "H": H, "S": S, "D": D, "us": us,
                          "turns": keep[D], "other_turns_us": other,
                          "sdpa_us": sdpa,
                          "bound_us": b_ms * 1e3,
                          "pct_of_bound": 100 * b_ms * 1e3 / us,
                          "card": card}), flush=True)
        del q, k, v
    L, B, E = 32, 8, 4096
    x = rnd(B, E)
    lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(L)]
    s = torch.rand(L, generator=gen, device="cuda") * 0.01 + 0.002
    for kind in ("bf16", "int8"):
        if kind == "bf16":
            w = rnd(L, E, E) * 0.02
        else:
            w = torch.randint(-127, 128, (L, E, E), generator=gen,
                              device="cuda", dtype=torch.int8)
        us = 1e3 * time_graph_ms(lambda i: dk.matvec_stacked(x, w, s,
                                                             lids[i]), n=L)
        fma = 1e3 * time_graph_ms(lambda i: dk.matvec_stacked_fma(
            x, w, s, lids[i]), n=L)
        mm = None if kind == "int8" else 1e3 * time_graph_ms(
            lambda i: torch.matmul(x, w[i]), n=L)
        b_ms, _ = bound(B * E * 2 + E * E * w.element_size() + 4
                        + B * E * 2, 2 * B * E * E)
        print(json.dumps({"row": f"matvec_stacked {kind}", "B": B, "K": E,
                          "N": E, "us": us, "fma_us": fma, "matmul_us": mm,
                          "bound_us": b_ms * 1e3,
                          "pct_of_bound": 100 * b_ms * 1e3 / us,
                          "card": card}), flush=True)
        del w
    if "--sweep" not in sys.argv:
        return
    for kind in ("bf16", "int8"):
        for K in (1024, 2048, 4096, 8192):
            xk = rnd(B, K)
            if kind == "bf16":
                w = rnd(8, K, E) * 0.02
            else:
                w = torch.randint(-127, 128, (8, K, E), generator=gen,
                                  device="cuda", dtype=torch.int8)
            us = 1e3 * time_graph_ms(lambda i: dk.matvec_stacked(
                xk, w, s[:8], lids[i % 8]), n=32)
            print(json.dumps({"sweep": f"matvec_stacked {kind}", "K": K,
                              "N": E, "us": us,
                              "plan": dk.matvec_tma_plan(
                                  B, K, E, w.element_size())._asdict(),
                              "card": card}), flush=True)
            del w
    for D in (64, 128):
        for t in (1, 2, 4, 8):
            S, BH = 128 * t, 1320 // t
            q, k, v = (rnd(1, BH, S, D) for _ in range(3))
            us = 1e3 * time_graph_ms(lambda i: fa.flash_attention_fwd(
                q, k, v, causal=False), n=8)
            print(json.dumps({"sweep": "flash_attention_fwd", "D": D,
                              "key_tiles_a_block": t, "blocks": t * BH,
                              "S": S, "BH": BH, "us": us, "card": card}),
                  flush=True)
            del q, k, v


if __name__ == "__main__":
    main()
