"""Where a redesigned kernel's time goes: the flash forward, the flash
backward, the decode projections, decode attention and the block-sparse
kernels rebuilt with parts switched off, timed beside the kernel as it
is, on one card.

    python3 tests/perf/torch_kernel_ablate.py [fwd] [bwd] [mvrows] [decode]
        [mvhost] [bsdkv] [bsrows] [decode_rows] [decode_smoke]

(default: all of them).

Each variant is csrc/flash_attention.cu or csrc/decode.cu with text
patches applied (every anchor must occur exactly once: the script raises
when the source has moved on), compiled by nvcc with the build's flags
into a library of its own and called through the same C entry point.
The results of a variant are wrong by design; only its time is read.

Flash forward (GPT-2 training's B 8 x 20 heads x S 1024 at D 64, the
fast path's B 8 x 32 heads x S 2048 at D 128, causal, the wrapper's turn
setting): ``no_softmax`` (P = S, no max, exp or sums), ``no_s`` (no
S = Q K^T products), ``no_pv`` (no O += P V products), ``no_loads`` (the
producer completes each K/V stage without loading it), and their
combinations ``loads_only``, ``products_only`` and ``sync_only``.
Flash backward (the same two shapes, causal, delta given):
``no_dq_wait`` (the dQ writer does not wait for the earlier key tiles'
adds: not deterministic, timed only), ``no_dq_writer`` (the staging tiles
are freed unread: no dq), ``no_finals`` (the last contributor adds its
part but writes no dq), ``no_bulk`` (the writers store or add nothing),
``no_math`` (no exp, p or ds),
``no_products`` (none of the five products), ``no_loads`` (the producer
completes each stage without loading it), and the combinations
``loads_only``, ``products_only`` and ``sync_only``.
``mvrows``: the decode projections (csrc/decode.cu proj_tma_kernel) at
LLaMA-7B's four rows (ln_qkv_stacked and out_ffn_stacked, bf16 and int8
codes, 8 slots): ``loads_only`` (no prologue, widening or products),
``products_only`` (the producer completes each stage without loading
it), ``prologue_only`` (the norm's statistics and u alone),
``widen_only`` (int8: the widening alone), ``sync_only``; then out_ffn
under the other gate/up pairing and both rows at 16 slots, as they are,
and matvec_stacked at LLaMA-7B's o-projection at B 1 and 8 in every
variant (see mvrows_ablation). ``mvhost``: the host's time a call (ctypes, plan,
tensor maps, launch; no device wait) of the three LLaMA-7B bf16 entries
at 8 slots, with the tensor-map cache and without (``no_map_cache``). Decode attention (bf16 caches: GPT-2
large's fast route at b1, LLaMA-7B's at b8, ctx 2048, pos 2034, and
GPT-2's paged serve positions): ``no_combine`` (the splits' states left
unmerged), ``loads_only`` (no products or softmax), ``products_only``
(the producer completes each stage without loading it), ``sync_only``;
then the kernel as it is under split plans of 1, 2 and 4 blocks an SM,
split below 1.5 (head, slot) pairs an SM (the wrapper's rule) and
always. Block-sparse dk/dv (BERT-large's layer, the Fixed layout at block
16): ``loads_only`` (no products), ``products_only`` (the producer
completes each stage without loading it), ``sync_only``; then the kernel
at B 1 and on one head alone. Block-sparse forward and dq (``bsrows``,
the same layer): ``loads_only``, ``products_only``, ``sync_only`` as for
dk/dv, the kernel with the other keys a step (64 or 128,
``other_step``) and with the other blocks an SM (the forward 2 with 4
K/V stages, dq 3 with 3: ``other_blocks``); then the kernel and
``other_step`` at B 1, on one head alone and at the shared BigBird
layout at block 64. ``decode_rows``: decode attention with 4
or 8 query rows a KV head (GQA) at D 128 and 64, stacked and paged, bf16
and int8, the kernel as it is. ``decode_smoke``: the LLaMA-7B b8 row of
decode_attention_stacked under the conditions chip_smoke.py times it in
(see decode_smoke_conditions).
One JSON line a time, with the card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import time_graph_ms  # noqa: E402
from deepspeed_tpu_torch.ops.cuda import builder  # noqa: E402
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

FLASH_PATCHES = {
    "no_softmax": [(
        "                                             float c) {\n"
        "  const int t4 = threadIdx.x & 3;\n",
        "                                             float c) {\n"
        "  alpha[0] = alpha[1] = 1.f;\n  return;\n"
        "  const int t4 = threadIdx.x & 3;\n")],
    "no_s": [(
        "                                        const unsigned char* kb) {\n",
        "                                        const unsigned char* kb) {\n"
        "  return;\n")],
    "no_pv": [(
        "                                         const unsigned char* vb) {\n",
        "                                         const unsigned char* vb) {\n"
        "  return;\n")],
    "no_loads": [(
        "        sm90::mbar_wait(&k_empty[ks_], ((it / KST) & 1) ^ 1);\n",
        "        sm90::mbar_wait(&k_empty[ks_], ((it / KST) & 1) ^ 1);\n"
        "        sm90::mbar_arrive(&k_full[ks_]);\n"
        "        sm90::mbar_wait(&v_empty[vs_], ((it / VST) & 1) ^ 1);\n"
        "        sm90::mbar_arrive(&v_full[vs_]);\n"
        "        continue;\n")],
}
FLASH_VARIANTS = {
    "kernel": [], "no_softmax": ["no_softmax"], "no_s": ["no_s"],
    "no_pv": ["no_pv"], "no_loads": ["no_loads"],
    "loads_only": ["no_softmax", "no_s", "no_pv"],
    "products_only": ["no_softmax", "no_loads"],
    "sync_only": ["no_softmax", "no_s", "no_pv", "no_loads"]}
BWD_PATCHES = {
    "no_dq_wait": [(
        "  for (long long n = 0; sm90::ld_acquire(cnt) != kt; ++n) {\n",
        "  for (long long n = 0; false; ++n) {\n")],
    "no_dq_writer": [(
        "        sm90::mbar_wait(&dq_full[s], (dit / DQST) & 1);\n",
        "        sm90::mbar_wait(&dq_full[s], (dit / DQST) & 1);\n"
        "        if (lane == 0) sm90::mbar_arrive(&dq_empty[s]);\n"
        "        continue;\n")],
    "no_finals": [
        ("          if (last) {\n            sm90::mbar_expect_tx",
         "          if (false) {\n            sm90::mbar_expect_tx"),
        ("        if (last) {\n          if (kt > 0) sm90::mbar_wait",
         "        if (false) {\n          if (kt > 0) sm90::mbar_wait")],
    "no_bulk": [
        ("            sm90::bulk_reduce_add_f32(acc, part, C::DQ_BYTES);\n",
         ""),
        ("            sm90::bulk_store(acc, part, C::DQ_BYTES);\n", "")],
    "no_math": [(
        "                                         int S, int causal, float c) {\n",
        "                                         int S, int causal, float c) {\n"
        "  return;\n")],
    "no_products": [
        ("                                              int half) {\n",
         "                                              int half) {\n"
         "  return;\n"),
        ("                                              const unsigned char* dob) {\n",
         "                                              const unsigned char* dob) {\n"
         "  return;\n"),
        ("                                             const unsigned char* kbox) {\n",
         "                                             const unsigned char* kbox) {\n"
         "  return;\n")],
    "no_loads": [
        ("          sm90::mbar_expect_tx(&kv_full[ks_], 2 * C::KV_BYTES);\n",
         "          sm90::mbar_arrive(&kv_full[ks_]);\n"),
        ("          for (int j = 0; j < DB; ++j) {\n"
         "            sm90::tma_load_3d(kb + j * BN * BOX_ROW",
         "          for (int j = 0; j < 0; ++j) {\n"
         "            sm90::tma_load_3d(kb + j * BN * BOX_ROW"),
        ("            sm90::mbar_expect_tx(&q_full[st], 2 * C::QT_BYTES);\n",
         "            sm90::mbar_arrive(&q_full[st]);\n"),
        ("            for (int j = 0; j < DB; ++j) {\n"
         "              sm90::tma_load_3d(qb + j * BQ * BOX_ROW",
         "            for (int j = 0; j < 0; ++j) {\n"
         "              sm90::tma_load_3d(qb + j * BQ * BOX_ROW"),
        ("            sm90::cp_async_4(ld + e, lse + at, bytes);\n"
         "            sm90::cp_async_4(ld + BQ + e, delta + at, bytes);\n", ""),
        ("          sm90::cp_async_arrive(&q_full[st]);\n",
         "          sm90::mbar_arrive(&q_full[st]);\n")],
}
BWD_VARIANTS = {
    "kernel": [], "no_dq_wait": ["no_dq_wait"],
    "no_dq_writer": ["no_dq_writer", "no_dq_wait"],
    "no_finals": ["no_finals"],
    "no_bulk": ["no_bulk"], "no_math": ["no_math"],
    "no_products": ["no_products"], "no_loads": ["no_loads"],
    "loads_only": ["no_math", "no_products", "no_dq_writer", "no_dq_wait"],
    "products_only": ["no_loads", "no_math", "no_dq_writer", "no_dq_wait"],
    "sync_only": ["no_loads", "no_math", "no_products", "no_dq_writer",
                  "no_dq_wait"]}
MV_PATCHES = {
    "no_loads": [(
        "          sm90::mbar_expect_tx(&full[s], C::STAGE);\n",
        "          sm90::mbar_arrive(&full[s]);\n          continue;\n")],
    "no_products": [(
        "  sm90::wgmma_ss<NB, 1, 0>(d, sm90::wgmma_desc(a, MV_BOX, 1024), db, "
        "0);\n", "")],
    # the tensor maps encoded by the CUDA driver at every launch
    "no_map_cache": [("#include \"sm90.cuh\"\n",
                      "#include \"sm90.cuh\"\n"
                      "#define encode_tiled_cached encode_tiled\n")],
    "no_widen": [("            widen_stage(st + m * MV_BOX, cb);\n", "")],
    "no_prologue": [
        ("      for (int r = rank + warp * nblk; r < p.B; r += kWarps * nblk) {\n",
         "      for (int r = p.B; r < p.B; r += kWarps * nblk) {\n"),
        ("      norm_slice<NB, PRO>(p, stat, u, l, k_lo);\n", "")],
}
MV_VARIANTS = {
    "kernel": [], "loads_only": ["no_products", "no_widen", "no_prologue"],
    "products_only": ["no_loads", "no_widen", "no_prologue"],
    "prologue_only": ["no_loads", "no_products", "no_widen"],
    "widen_only": ["no_loads", "no_products", "no_prologue"],
    "sync_only": ["no_loads", "no_products", "no_widen", "no_prologue"],
    "no_map_cache": ["no_map_cache"]}
MV_ENTRIES = ("dstpu_ln_qkv_stacked", "dstpu_out_ffn_glu_stacked",
              "dstpu_matvec_stacked")
DECODE_PATCHES = {
    "no_loads": [
        ("          sm90::mbar_expect_tx(&full[s], ng * C::GROUP_BYTES);\n",
         "          sm90::mbar_arrive(&full[s]);\n"),
        ("        if (ptb ? lane < ng : lane == 0) {\n",
         "        if (false) {\n")],
    "no_products": [("          if (key < k1) {\n", "          if (false) {\n"),
                    ("          if (key0 < k1) {\n",
                     "          if (false) {\n")],
    "no_combine": [("  if (n_live == 1) return;\n\n", "  return;\n\n")],
}
# (shape, B, KV heads, R, D, cache length or None for the paged pool)
DECODE_ROWS_SHAPES = (("gqa_r4_b1", 1, 8, 4, 128, 2048),
                      ("gqa_r4_b8", 8, 8, 4, 128, 2048),
                      ("gqa_r4_paged", 8, 8, 4, 128, None),
                      ("gqa_r8_b8", 8, 4, 8, 128, 2048),
                      ("gqa_r4_d64_b8", 8, 5, 4, 64, 2048))
DECODE_VARIANTS = {"kernel": [], "no_combine": ["no_combine"],
                   "loads_only": ["no_products"],
                   "products_only": ["no_loads"],
                   "sync_only": ["no_loads", "no_products"]}
BSDKV_PATCHES = {
    "no_loads": [
        ("      sm90::mbar_expect_tx(&kv_full[ks], 2 * TILE_BYTES);\n",
         "      sm90::mbar_arrive(&kv_full[ks]);\n      ++kvi;\n"
         "      for (int s = 0; s < steps; ++s, ++it) {\n"
         "        const int st = it % DKV_NST;\n"
         "        sm90::mbar_wait(&empty[st], ((it / DKV_NST) & 1) ^ 1);\n"
         "        sm90::mbar_arrive(&full[st]);\n      }\n"
         "      continue;\n")],
    "no_products": [("      for (int s = 0; s < steps; ++s, ++it) {\n"
                     "        const int st = it % DKV_NST;\n"
                     "        const unsigned char* qb",
                     "      for (int s = 0; s < steps; ++s, ++it) {\n"
                     "        const int st = it % DKV_NST;\n"
                     "        if (true) {\n"
                     "          sm90::mbar_wait(&full[st], (it / DKV_NST) & 1);\n"
                     "          __syncwarp();\n"
                     "          if (lane == 0) sm90::mbar_arrive(&empty[st]);\n"
                     "          continue;\n        }\n"
                     "        const unsigned char* qb")],
}
BSDKV_VARIANTS = {"kernel": [], "loads_only": ["no_products"],
                  "products_only": ["no_loads"],
                  "sync_only": ["no_loads", "no_products"]}
BSROWS_PATCHES = {
    "no_loads": [
        ("        sm90::mbar_expect_tx(&full[st], 2 * RW_KV_BYTES);\n",
         "        sm90::mbar_arrive(&full[st]);\n        continue;\n")],
    "no_products": [
        ("    if (steps > 0) {\n      const int slot = qi % 2;\n",
         "    if (steps > 0 && true) {\n"
         "      const int slot = qi % 2;\n"
         "      sm90::mbar_wait(&q_full[slot], (qi / 2) & 1);\n"
         "      for (int j = 0; j < steps; ++j, ++it) {\n"
         "        sm90::mbar_wait(&full[it % NST], (it / NST) & 1);\n"
         "        rw_release(&empty[it % NST]);\n      }\n"
         "      rw_release(&q_empty[slot]);\n      ++qi;\n"
         "    } else if (steps > 0) {\n      const int slot = qi % 2;\n")],
    # the forward two blocks an SM with 4 K/V stages, dq three with 3
    "other_blocks": [
        ("  static constexpr int CTAS = DQ ? 2 : 3;",
         "  static constexpr int CTAS = DQ ? 3 : 2;"),
        ("  static constexpr int NST = DQ ? 4 : 3;",
         "  static constexpr int NST = DQ ? 3 : 4;")],
    # dq's dS after its dQ product, not under it (fewer live registers),
    # three blocks an SM with 3 K/V stages
    "dq_serial": [
        ("            rw_ds<RW_KN>(sacc, dpa, ls, dl, valid, cs);\n"
         "          } else {\n",
         "          } else {\n"),
        ("            rw_pack<RW_KN>(x, dpa);\n          } else {\n",
         "            rw_ds<RW_KN>(sacc, dpa, ls, dl, valid, cs);\n"
         "            rw_pack<RW_KN>(x, dpa);\n          } else {\n"),
        ("  static constexpr int CTAS = DQ ? 2 : 3;",
         "  static constexpr int CTAS = 3;"),
        ("  static constexpr int NST = DQ ? 4 : 3;",
         "  static constexpr int NST = 3;")],
}
BSROWS_VARIANTS = {"kernel": [], "loads_only": ["no_products"],
                   "products_only": ["no_loads"],
                   "sync_only": ["no_loads", "no_products"],
                   "other_step": ["step"], "other_blocks": ["other_blocks"],
                   "dq_serial": ["dq_serial"]}
# (shape, B, KV heads, D, cache length or None for the paged pool, pos)
DECODE_SHAPES = (("gpt2_b1", 1, 20, 64, 2048, 2034),
                 ("llama7b_b8", 8, 32, 128, 2048, 2034),
                 ("gpt2_serve_paged", 8, 20, 64, None, None))
# the split plan's blocks an SM (split below 1.5 pairs an SM as the
# wrapper does, and always), each timed on the kernel as it is
DECODE_BLOCKS_PER_SM = (1, 2, 4)


def build(src_name, patches, variants, tmp, entry):
    """{variant: the library's C entry ``entry``} for each variant of one
    source ({variant: {name: entry}} for a tuple of names)."""
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    with open(os.path.join(builder.CSRC, src_name)) as f:
        text = f.read()
    procs = {}
    for name, keys in variants.items():
        src = text
        for key in keys:
            for old, new in patches[key]:
                if src.count(old) != 1:
                    raise RuntimeError(f"{src_name}: the anchor of {key!r} "
                                       f"is not in the source once")
                src = src.replace(old, new)
        path = os.path.join(tmp, f"{names[0]}_{name}_{src_name}")
        with open(path, "w") as f:
            f.write(src)
        lib = path + ".so"
        procs[name] = (lib, subprocess.Popen(
            [builder._nvcc(), *builder.NVCC_FLAGS, "-shared", "-I",
             builder.CSRC, "-o", lib, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name} {src_name}:\n{out}")
        dll, fns = ctypes.CDLL(lib), {}
        for e in names:
            fns[e] = getattr(dll, e)
            fns[e].argtypes = builder.SIGNATURES[e]
            fns[e].restype = ctypes.c_int
        entries[name] = fns[entry] if isinstance(entry, str) else fns
    return entries


def bsdkv_ablation(entries, gen, stream, card):
    """blocksparse_bwd_dkv at BERT-large's layer (H 16, S 4096, the Fixed
    layout at block 16): each variant at B 4, then the kernel as it is at
    B 1 and on one head of the layout alone (the fewest tiles)."""
    from chip_smoke import bert_model_config
    from deepspeed_tpu_torch.ops.cuda import blocksparse as bs
    H, S, D = 16, 4096, 64
    sp = bert_model_config().sparsity_config
    np.random.seed(0)
    full = sp.make_layout(S)

    def timed(fn, B, heads, layout):
        tables = bs.layout_tables(layout, S, sp.block, heads, "cuda")
        q, k, v, do = (torch.randn(B * heads, S, D, generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o, lse = bs.blocksparse_fwd(q, k, v, tables)
        delta = (do.float() * o).sum(-1)
        dk, dv = torch.empty_like(o), torch.empty_like(o)
        work = tables.dkv_work()
        tiles = work.device_plan("cuda")

        def call(i=0, fn=fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(),
                     tables.rows_t.data_ptr(), tiles.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), B * heads, tables.heads,
                     S, sp.block, tables.rows_t.shape[-1], tiles.shape[0],
                     D ** -0.5, stream())
            if err:
                raise RuntimeError(f"cudaError_t {err}")
        return work.summary(), 1e3 * time_graph_ms(call, n=8, reps=5)
    for name, fn in entries.items():
        work, us = timed(fn, 4, H, full)
        print(json.dumps({"kernel": "blocksparse_bwd_dkv", "shape": "B4",
                          "variant": name, "work": work, "us": us,
                          "card": card}), flush=True)
    for shape, B, heads, layout in (("B1", 1, H, full),
                                    ("one_head", 1, 1, full[:1])):
        work, us = timed(entries["kernel"], B, heads, layout)
        print(json.dumps({"kernel": "blocksparse_bwd_dkv", "shape": shape,
                          "variant": "kernel", "work": work, "us": us,
                          "card": card}), flush=True)


def bsrows_variants(tmp):
    """The forward and dq kernel variants: BSROWS_VARIANTS, where "step"
    switches the keys a step (RW_KN) between 64 and 128, from whichever
    the source has (at 128 keys a ring of 2 stages: 3 or 4 of 32 KB do
    not fit beside the Q slots at the blocks an SM the source sets)."""
    with open(os.path.join(builder.CSRC, "blocksparse.cu")) as f:
        text = f.read()
    a, b = (64, 128) if "constexpr int RW_KN = 64;" in text else (128, 64)
    patches = dict(BSROWS_PATCHES, step=[
        (f"constexpr int RW_KN = {a};", f"constexpr int RW_KN = {b};"),
        ("  static constexpr int NST = DQ ? 4 : 3;",
         "  static constexpr int NST = 2;")])
    return build("blocksparse.cu", patches, BSROWS_VARIANTS, tmp,
                 ("dstpu_bs_fwd", "dstpu_bs_bwd_dq"))


def bsrows_ablation(entries, gen, stream, card):
    """blocksparse_fwd and blocksparse_bwd_dq at BERT-large's layer (H 16,
    S 4096, the Fixed layout at block 16): each variant at B 4, then the
    kernel as it is at B 1, on one head of the layout alone and at the
    shared BigBird layout at block 64 (B 4)."""
    from chip_smoke import bert_model_config
    from deepspeed_tpu_torch.ops.cuda import blocksparse as bs
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
        BigBirdSparsityConfig
    H, S, D = 16, 4096, 64
    sp = bert_model_config().sparsity_config
    np.random.seed(0)
    full = sp.make_layout(S)
    bigbird = BigBirdSparsityConfig(
        num_heads=H, block=64, num_random_blocks=1,
        num_sliding_window_blocks=3, num_global_blocks=1).make_layout(S)

    def timed(fns, B, heads, layout, block):
        tables = bs.layout_tables(layout, S, block, heads, "cuda")
        q, k, v, do = (torch.randn(B * heads, S, D, generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o, lse = bs.blocksparse_fwd_plain(q, k, v, tables)
        delta = (do.float() * o).sum(-1)
        dq = torch.empty_like(q)
        work = tables.row_work()
        tiles = work.device_plan("cuda")
        common = (B * heads, tables.heads, S, block, tables.cols.shape[-1],
                  tiles.shape[0], D ** -0.5)

        def fwd(i=0):
            err = fns["dstpu_bs_fwd"](
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                tables.cols.data_ptr(), tiles.data_ptr(), o.data_ptr(),
                lse.data_ptr(), *common, stream())
            if err:
                raise RuntimeError(f"cudaError_t {err}")

        def dqf(i=0):
            err = fns["dstpu_bs_bwd_dq"](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), tables.cols.data_ptr(),
                tiles.data_ptr(), dq.data_ptr(), *common, stream())
            if err:
                raise RuntimeError(f"cudaError_t {err}")
        dq_us = 1e3 * time_graph_ms(dqf, n=8, reps=5)   # lse stays plain's
        fwd_us = 1e3 * time_graph_ms(fwd, n=8, reps=5)
        return work.summary(), fwd_us, dq_us
    for name, fns in entries.items():
        work, fwd_us, dq_us = timed(fns, 4, H, full, sp.block)
        print(json.dumps({"kernel": "blocksparse_fwd/bwd_dq", "shape": "B4",
                          "variant": name, "work": work, "fwd_us": fwd_us,
                          "dq_us": dq_us, "card": card}), flush=True)
    for shape, B, heads, layout, block in (
            ("B1", 1, H, full, sp.block), ("one_head", 1, 1, full[:1],
                                           sp.block),
            ("bigbird_b64", 4, H, bigbird, 64)):
        for name in ("kernel", "other_step"):
            work, fwd_us, dq_us = timed(entries[name], B, heads, layout,
                                        block)
            print(json.dumps({"kernel": "blocksparse_fwd/bwd_dq",
                              "shape": shape, "variant": name, "work": work,
                              "fwd_us": fwd_us, "dq_us": dq_us,
                              "card": card}), flush=True)


def decode_rows_ablation(gen, stream, card):
    """decode_attention with R > 1 query rows a KV head (GQA, the kernel's
    tensor-core path; bf16 and int8 caches) at the wrapper's split plan,
    against the plain version (its error and its eager time), beside the
    bound of the live rows' bytes and, over a bf16 stacked cache, SDPA
    with ``enable_gqa`` over the live keys (graph-replayed)."""
    from chip_smoke import time_ms
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = builder.kernels()
    n = 32
    lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(n)]
    for shape, B, H, R, D, L in DECODE_ROWS_SHAPES:
        q = torch.randn(B, H, R, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        out = torch.empty_like(q)
        if L is None:    # chip_smoke's serve positions, 64 pages of 16
            page, maxp, NB = 16, 64, B * 64 + 1
            pos = torch.tensor([511, 300, 17, 700, 100, 1000, 64, -1],
                               dtype=torch.int32, device="cuda")
            pt = (torch.randperm(NB - 1, generator=gen, device="cuda")
                  [:B * maxp] + 1).reshape(B, maxp).to(torch.int32)
            shape5, pt_ptr, stride = (n, NB, H, page, D), pt.data_ptr(), 1
            live = int((pos + 1).clamp(min=0).sum())
        else:
            page, maxp, NB, p = L, 1, B, L - 14
            pos = torch.tensor([p], dtype=torch.int32, device="cuda")
            shape5, pt_ptr, stride = (n, B, H, L, D), None, 0
            live = B * (p + 1)
        plan = dk.decode_split_plan(B, H, maxp * page, sms)
        for kind in ("bf16", "int8"):
            if kind == "bf16":
                kc, vc = (torch.randn(shape5, generator=gen, device="cuda")
                          .to(torch.bfloat16) for _ in range(2))
                kw = {}
            else:
                kc, vc = (torch.randint(-127, 128, shape5, generator=gen,
                                        device="cuda", dtype=torch.int8)
                          for _ in range(2))
                kw = {k: torch.rand(shape5[:3] + (1, page), generator=gen,
                                    device="cuda") * 0.01 + 0.002
                      for k in ("k_scale", "v_scale")}
            ks_ptr, vs_ptr = (_ptr_of(kw.get(k))
                              for k in ("k_scale", "v_scale"))
            def plain():
                if L is None:
                    return dk.decode_attention_paged_plain(q, kc, vc, pos,
                                                           pt, 0, **kw)
                return dk.decode_attention_stacked_plain(q, kc, vc, pos, 0,
                                                         **kw)
            ref = plain().float()
            plain_us = 1e3 * time_ms(plain, reps=3, inner=1, warmup=1)
            sdpa_us = None
            if L is not None and not kw:
                qs = q.reshape(B, H * R, 1, D)
                try:
                    sdpa_us = 1e3 * time_graph_ms(
                        lambda i: torch.nn.functional
                        .scaled_dot_product_attention(
                            qs, kc[i, :, :, :p + 1], vc[i, :, :, :p + 1],
                            enable_gqa=True), n=n)
                except TypeError:      # a torch without enable_gqa
                    sdpa_us = None
            row = D * kc.element_size() + (4 if kw else 0)

            def call(i):
                lib.call("dstpu_decode_attention", q.data_ptr(),
                         kc.data_ptr(), vc.data_ptr(), ks_ptr, vs_ptr,
                         pos.data_ptr(), pt_ptr, lids[i].data_ptr(),
                         None, None, 0, 0, out.data_ptr(), B, H, R, D, NB,
                         page, maxp, 0,
                         stride, plan.chunk, plan.n_split, D ** -0.5,
                         stream())
            call(0)
            torch.cuda.synchronize()
            print(json.dumps({"kernel": "decode_attention", "shape": shape,
                              "cache": kind, "B": B, "H": H, "R": R, "D": D,
                              "variant": "kernel", "plan": plan._asdict(),
                              "max_abs_err": float(
                                  (out.float() - ref).abs().max()),
                              "us": 1e3 * time_graph_ms(call, n=n),
                              "bound_us": 1e6 * live * H * row * 2 / 3.35e12,
                              "plain_us": plain_us, "sdpa_us": sdpa_us,
                              "card": card}), flush=True)
            del kc, vc, kw


def _ptr_of(t):
    return None if t is None else t.data_ptr()


def _clocks():
    """The card's SM and memory clocks, temperature and power draw."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def decode_smoke_conditions(gen, card):
    """decode_attention_stacked at the fast path's b8 D 128 shape (32
    layers of ctx 2048, pos 2034; bf16 and int8 caches) timed as
    torch_kernel_rows.py times it (CUDA-graph replay) and eagerly as
    chip_smoke's ``call_us`` (host launches between), with the card's
    clocks and temperature: at the start of the process, after 20 s of
    bf16 GEMMs, after 30 s idle, with chip_smoke's cache values (x 0.5),
    beside 20 GB of other memory, and after chip_smoke's own
    ``generate_kernel_rows`` (its rows print too) with the LLaMA-7B int8
    engine built, to find what separates chip_smoke's row from the rows
    script's."""
    import itertools
    import time
    import chip_smoke as cs
    from deepspeed_tpu_torch.models.llama import llama_7b
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    B, H, D, L, p, n = 8, 32, 128, 2048, 2034, 32
    pos = torch.tensor([p], dtype=torch.int32, device="cuda")
    lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(n)]

    def rows(condition, scale=1.0):
        q = torch.randn(B, H, 1, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        shape = (n, B, H, L, D)
        for kind in ("bf16", "int8"):
            if kind == "bf16":
                kc, vc = ((torch.randn(shape, generator=gen, device="cuda")
                           * scale).to(torch.bfloat16) for _ in range(2))
                kw = {}
            else:
                kc, vc = (torch.randint(-127, 128, shape, generator=gen,
                                        device="cuda", dtype=torch.int8)
                          for _ in range(2))
                kw = {k: torch.rand(shape[:3] + (1, L), generator=gen,
                                    device="cuda") * 0.01 + 0.002
                      for k in ("k_scale", "v_scale")}
            clocks = _clocks()
            us = 1e3 * time_graph_ms(lambda i: dk.decode_attention_stacked(
                q, kc, vc, pos, lids[i], **kw), n=n)
            cyc = itertools.cycle(range(n))
            eager = 1e3 * cs.time_ms(lambda: dk.decode_attention_stacked(
                q, kc, vc, pos, lids[next(cyc)], **kw))
            print(json.dumps({"kernel": "decode_attention_stacked",
                              "shape": "llama7b_b8", "cache": kind,
                              "condition": condition, "us": us,
                              "eager_us": eager,
                              "clocks_sm_mem_temp_power": clocks,
                              "mem_allocated_gb":
                                  torch.cuda.memory_allocated() / 1e9,
                              "card": card}), flush=True)
            del kc, vc, kw
        torch.cuda.empty_cache()
    rows("process_start")
    a = torch.randn(8192, 8192, generator=gen, device="cuda").to(
        torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 20:
        for _ in range(50):
            a @ a
        torch.cuda.synchronize()
    del a
    rows("after_20s_gemm")
    time.sleep(30)
    rows("after_30s_idle")
    rows("values_x0.5", 0.5)
    filler = torch.ones(20 << 30, dtype=torch.uint8, device="cuda")
    rows("beside_20GB")
    del filler
    torch.cuda.empty_cache()
    cfg = llama_7b()
    eng = cs.llama_int8_init(cfg)
    cs.generate_kernel_rows(eng, cfg, gen)
    rows("after_generate_kernel_rows_engine_built")
    del eng
    torch.cuda.empty_cache()


def decode_ablation(entries, gen, stream, card):
    """decode_attention over bf16 caches: each variant at the split plan
    the wrapper takes, then the kernel as it is at other plans' blocks an
    SM (``ATTN_BLOCKS_PER_SM``)."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, B, H, D, L, p in DECODE_SHAPES:
        n = 32
        q = torch.randn(B, H, 1, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        out = torch.empty_like(q)
        lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
                for i in range(n)]
        if L is None:    # chip_smoke's serve positions, 64 pages of 16
            page, maxp, NB = 16, 64, B * 64 + 1
            pos = torch.tensor([511, 300, 17, 700, 100, 1000, 64, -1],
                               dtype=torch.int32, device="cuda")
            pt = (torch.randperm(NB - 1, generator=gen, device="cuda")
                  [:B * maxp] + 1).reshape(B, maxp).to(torch.int32)
            shape5, pt_ptr, stride = (n, NB, H, page, D), pt.data_ptr(), 1
        else:
            page, maxp, NB = L, 1, B
            pos = torch.tensor([p], dtype=torch.int32, device="cuda")
            shape5, pt_ptr, stride = (n, B, H, L, D), None, 0
        kc, vc = (torch.randn(shape5, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        def timed(fn, plan):
            def call(i, fn=fn):
                err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), None,
                         None, pos.data_ptr(), pt_ptr, lids[i].data_ptr(),
                         None, None, 0, 0, out.data_ptr(), B, H, 1, D, NB,
                         page, maxp, 0,
                         stride, plan.chunk, plan.n_split, D ** -0.5,
                         stream())
                if err:
                    raise RuntimeError(f"cudaError_t {err}")
            return 1e3 * time_graph_ms(call, n=n)
        plan = dk.decode_split_plan(B, H, maxp * page, sms)
        for name, fn in entries.items():
            print(json.dumps({"kernel": "decode_attention", "shape": shape,
                              "variant": name, "plan": plan._asdict(),
                              "us": timed(fn, plan), "card": card}),
                  flush=True)
        keep = dk.ATTN_BLOCKS_PER_SM, dk.ATTN_SPLIT_BELOW
        try:
            for below in (keep[1], float("inf")):
                for per_sm in DECODE_BLOCKS_PER_SM:
                    dk.ATTN_BLOCKS_PER_SM, dk.ATTN_SPLIT_BELOW = per_sm, below
                    plan = dk.decode_split_plan(B, H, maxp * page, sms)
                    print(json.dumps({"kernel": "decode_attention",
                                      "shape": shape, "variant": "kernel",
                                      "blocks_per_sm": per_sm,
                                      "split_below": below,
                                      "plan": plan._asdict(),
                                      "us": timed(entries["kernel"], plan),
                                      "card": card}), flush=True)
        finally:
            dk.ATTN_BLOCKS_PER_SM, dk.ATTN_SPLIT_BELOW = keep
        del kc, vc


def mvrows_ablation(entries, gen, stream, card):
    """LLaMA-7B's four projection rows (``ln_qkv_stacked`` [8, 4096] x
    [32, 4096, 12288] and ``out_ffn_stacked``'s gate/up and down launches,
    F 11008; bf16 and int8 codes), each variant of ``MV_VARIANTS`` over
    the 32 layers at the wrapper's plan; then the bf16 out_ffn rows as
    they are under the other gate/up pairing ("split"; int8 takes "split"
    only: "both" fits no plan of two blocks an SM), both rows at 16
    slots, and matvec_stacked ([B, 4096] x [32, 4096, 4096], B 1 and 8)
    in each variant."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    L, E, N, F = 32, 4096, 12288, 11008
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(L)]
    ln_w = 1 + 0.1 * torch.randn(L, E, generator=gen, device="cuda")
    eps = 1e-6

    def weights(K, N_, w8):
        if w8:
            return torch.randint(-127, 128, (L, K, N_), generator=gen,
                                 device="cuda", dtype=torch.int8)
        return (torch.randn(L, K, N_, generator=gen, device="cuda")
                * 0.0112).to(torch.bfloat16)

    def plan_of(B, K, N_, wb, pro, pair):
        """(split, stages, clusters) of the wrapper's plan"""
        plan = dk.matvec_tma_plan(B, K, N_, wb, sms, pro, pair)
        return (plan.split, plan.stages, plan.clusters)

    def emit(row, name, us, **more):
        print(json.dumps({"kernel": row, "variant": name, "us": us,
                          **more, "card": card}), flush=True)

    for kind in ("bf16", "int8"):
        w8, wb = kind == "int8", 1 if kind == "int8" else 2
        s = (torch.rand(L, generator=gen, device="cuda") * 0.002 + 0.001
             if w8 else torch.ones(L, device="cuda"))
        wq = weights(E, N, w8)
        for B in (8, 16):
            x = torch.randn(B, E, generator=gen, device="cuda").to(
                torch.bfloat16)
            out = torch.empty(B, N, dtype=torch.bfloat16, device="cuda")
            plan = plan_of(B, E, N, wb, "rms_bf16", None)
            arr = (ctypes.c_int * 3)(*plan)
            for name, fns in entries.items():
                if B == 16 and name != "kernel":
                    continue

                def call(i, fn=fns["dstpu_ln_qkv_stacked"]):
                    err = fn(x.data_ptr(), ln_w.data_ptr(), None,
                             wq.data_ptr(), s.data_ptr(), None,
                             lids[i].data_ptr(), out.data_ptr(), B, E, N, L,
                             1, int(w8), arr, eps, stream())
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                emit(f"ln_qkv_stacked {kind}", name,
                     1e3 * time_graph_ms(call, n=L), B=B, plan=list(plan))
        del wq
        wg, wu, wd = weights(E, F, w8), weights(E, F, w8), weights(F, E, w8)
        for B in (8, 16):
            x = torch.randn(B, E, generator=gen, device="cuda").to(
                torch.bfloat16)
            h = torch.empty(B, F, dtype=torch.bfloat16, device="cuda")
            out = torch.empty(B, E, dtype=torch.bfloat16, device="cuda")
            for pair in ("split", "both") if wb == 2 else ("split",):
                gu = plan_of(B, E, F, wb, "rms_bf16", pair)
                dn = plan_of(B, F, E, wb, "copy", None)
                arr = (ctypes.c_int * 6)(*gu, *dn)
                for name, fns in entries.items():
                    if (B == 16 or pair != dk.GLU_PAIRING[wb]) \
                            and name != "kernel":
                        continue

                    def call(i, fn=fns["dstpu_out_ffn_glu_stacked"]):
                        err = fn(x.data_ptr(), ln_w.data_ptr(),
                                 wg.data_ptr(), s.data_ptr(), wu.data_ptr(),
                                 s.data_ptr(), wd.data_ptr(), s.data_ptr(),
                                 lids[i].data_ptr(), h.data_ptr(),
                                 out.data_ptr(), B, E, F, L, int(w8), arr,
                                 dk.PAIRS[pair], eps, stream())
                        if err:
                            raise RuntimeError(f"{name}: cudaError_t {err}")
                    emit(f"out_ffn_stacked {kind}", name,
                         1e3 * time_graph_ms(call, n=L), B=B, pair=pair,
                         gate_up=list(gu), down=list(dn))
        del wg, wu, wd
        wo = weights(E, E, w8)
        for B in (1, 8):
            x = torch.randn(B, E, generator=gen, device="cuda").to(
                torch.bfloat16)
            out = torch.empty(B, E, dtype=torch.bfloat16, device="cuda")
            plan = plan_of(B, E, E, wb, "copy", None)
            arr = (ctypes.c_int * 3)(*plan)
            for name, fns in entries.items():
                def call(i, fn=fns["dstpu_matvec_stacked"]):
                    err = fn(x.data_ptr(), wo.data_ptr(), s.data_ptr(),
                             lids[i].data_ptr(), out.data_ptr(), B, E, E, L,
                             int(w8), 0, arr, stream())
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                emit(f"matvec_stacked {kind}", name,
                     1e3 * time_graph_ms(call, n=L), B=B, plan=list(plan))
        del wo
        torch.cuda.empty_cache()


def mvhost(entries, gen, stream, card):
    """Host microseconds a call of dstpu_ln_qkv_stacked,
    dstpu_out_ffn_glu_stacked and dstpu_matvec_stacked at LLaMA-7B's bf16
    shapes, 8 slots, each variant: the best of 9 runs of 256 eager calls
    (8 over each of the 32 layers) with no device wait between them (the
    queue stays below its depth), then one synchronize; the variants take
    turns run by run."""
    import time
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    L, E, N, F, B = 32, 4096, 12288, 11008, 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
            for i in range(L)]
    ln_w = torch.ones(L, E, device="cuda")
    s = torch.ones(L, device="cuda")

    def w(*shape):
        return torch.zeros(*shape, device="cuda", dtype=torch.bfloat16)

    def plan(*launches):
        flat = []
        for K, N_, pro, pair in launches:
            p = dk.matvec_tma_plan(B, K, N_, 2, sms, pro, pair)
            flat += [p.split, p.stages, p.clusters]
        return (ctypes.c_int * len(flat))(*flat)

    wq, wg, wu, wd, wo = w(L, E, N), w(L, E, F), w(L, E, F), w(L, F, E), \
        w(L, E, E)
    x, h = w(B, E), w(B, F)
    out_n, out_e = w(B, N), w(B, E)
    pq = plan((E, N, "rms_bf16", None))
    pf = plan((E, F, "rms_bf16", dk.GLU_PAIRING[2]), (F, E, "copy", None))
    po = plan((E, E, "copy", None))
    calls = {
        "ln_qkv_stacked": lambda f, i: f["dstpu_ln_qkv_stacked"](
            x.data_ptr(), ln_w.data_ptr(), None, wq.data_ptr(), s.data_ptr(),
            None, lids[i].data_ptr(), out_n.data_ptr(), B, E, N, L, 1, 0, pq,
            1e-6, stream()),
        "out_ffn_stacked": lambda f, i: f["dstpu_out_ffn_glu_stacked"](
            x.data_ptr(), ln_w.data_ptr(), wg.data_ptr(), s.data_ptr(),
            wu.data_ptr(), s.data_ptr(), wd.data_ptr(), s.data_ptr(),
            lids[i].data_ptr(), h.data_ptr(), out_e.data_ptr(), B, E, F, L,
            0, pf, dk.PAIRS[dk.GLU_PAIRING[2]], 1e-6, stream()),
        "matvec_stacked": lambda f, i: f["dstpu_matvec_stacked"](
            x.data_ptr(), wo.data_ptr(), s.data_ptr(), lids[i].data_ptr(),
            out_e.data_ptr(), B, E, E, L, 0, 0, po, stream())}
    for row, call in calls.items():
        best = dict.fromkeys(entries, float("inf"))
        for _ in range(9):
            for name, fns in entries.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for r in range(8):
                    for i in range(L):
                        if call(fns, i):
                            raise RuntimeError(f"{row} {name}: launch")
                best[name] = min(best[name],
                                 (time.perf_counter() - t0) / (8 * L))
                torch.cuda.synchronize()
        for name, t in best.items():
            print(json.dumps({"host_us_a_call": row, "variant": name,
                              "us": t * 1e6, "card": card}), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def stream():   # the capturing stream inside a graph capture
        return torch.cuda.current_stream().cuda_stream

    parts = sys.argv[1:] or ["fwd", "bwd", "mvrows", "decode"]
    with tempfile.TemporaryDirectory() as tmp:
        flash = (build("flash_attention.cu", FLASH_PATCHES, FLASH_VARIANTS,
                       tmp, "dstpu_flash_fwd") if "fwd" in parts else {})
        bwd = (build("flash_attention.cu", BWD_PATCHES, BWD_VARIANTS, tmp,
                     "dstpu_flash_bwd") if "bwd" in parts else {})
        if "mvrows" in parts:
            mvrows_ablation(build("decode.cu", MV_PATCHES,
                                  {k: v for k, v in MV_VARIANTS.items()
                                   if k != "no_map_cache"}, tmp,
                                  MV_ENTRIES), gen, stream, card)
        if "mvhost" in parts:
            mvhost(build("decode.cu", MV_PATCHES,
                         {k: MV_VARIANTS[k]
                          for k in ("kernel", "no_map_cache")}, tmp,
                         MV_ENTRIES), gen, stream, card)
        if "bsdkv" in parts:
            bsdkv_ablation(build("blocksparse.cu", BSDKV_PATCHES,
                                 BSDKV_VARIANTS, tmp, "dstpu_bs_bwd_dkv"),
                           gen, stream, card)
        if "bsrows" in parts:
            bsrows_ablation(bsrows_variants(tmp), gen, stream, card)
        if "decode_rows" in parts:
            decode_rows_ablation(gen, stream, card)
        if "decode_smoke" in parts:
            decode_smoke_conditions(gen, card)
        if "decode" in parts:
            decode_ablation(build("decode.cu", DECODE_PATCHES,
                                  DECODE_VARIANTS, tmp,
                                  "dstpu_decode_attention"), gen, stream,
                            card)
        for shape, B, H, S, D in (("gpt2_train", 8, 20, 1024, 64),
                                  ("fast_path_prompt", 8, 32, 2048, 128)):
            q, k, v = (torch.randn(B, H, S, D, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            o, lse = torch.empty_like(q), torch.empty(B, H, S, device="cuda")
            for name, fn in flash.items():
                def call(i=0, fn=fn):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), lse.data_ptr(), B * H, H, H, S, D,
                             D ** -0.5, 1, int(fa.PINGPONG[D]), stream())
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                print(json.dumps({"kernel": "flash_attention_fwd",
                                  "shape": shape, "variant": name,
                                  "us": 1e3 * time_graph_ms(call, n=8),
                                  "card": card}), flush=True)
            del q, k, v, o, lse
        for shape, B, H, S, D in (("gpt2_train", 8, 20, 1024, 64),
                                  ("llama7b_train", 2, 32, 2048, 128)):
            if not bwd:
                break
            q, k, v, do = (torch.randn(B, H, S, D, generator=gen,
                                       device="cuda").to(torch.bfloat16)
                           for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
            delta = fa.flash_attention_bwd_delta_plain(o, do)
            dq, dk, dv = (torch.empty_like(q) for _ in range(3))
            n_qt = -(-S // fa.BWD_Q_TILE)
            acc = torch.empty(B * H * n_qt * fa.BWD_Q_TILE * D,
                              device="cuda")
            cnt = torch.zeros(B * H * n_qt, dtype=torch.int32, device="cuda")
            for name, fn in bwd.items():
                def call(i=0, fn=fn):
                    cnt.zero_()
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             acc.data_ptr(), cnt.data_ptr(), B * H, S, D,
                             D ** -0.5, 1, stream())
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                print(json.dumps({"kernel": "flash_attention_bwd",
                                  "shape": shape, "variant": name,
                                  "us": 1e3 * time_graph_ms(call, n=8),
                                  "card": card}), flush=True)
            del q, k, v, do, o, lse, delta, dq, dk, dv, acc


if __name__ == "__main__":
    main()
