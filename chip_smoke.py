"""Chip smoke for deepspeed_tpu_torch: GPT-2 large and LLaMA-7B paged
serving (each in bf16 and in int8), GPT-2 large ``generate()`` through
the fused inference layer, LLaMA-7B's dense fast path, GPT-2 large
training, LLaMA-7B training at half depth and its ``llama_generate``,
LLaMA-7B training at all 32 layers with ZeRO-Offload, GPT-2 large with
ZeRO-Infinity's NVMe tiers, BERT-large pretraining with block-sparse
attention, GPT-2 large MoQ quantize-aware training and GPT-2 large
ZeRO-3 training over four ranks on one NVIDIA GPU, through the
hand-written CUDA kernels.

    python3 chip_smoke.py

Phases, one JSON line each, each with its wall ``seconds``:

1. device   — the card (nvidia-smi name and power limit), CUDA version,
               and the time to build the kernels from ``csrc/*.cu``
               and the host libraries (``csrc/{cpu_adam,aio}.cpp``, g++);
               the host's memory and cores, the NVMe directory's
               filesystem and free space, the aio backend, and the
               pinned copy rates of 1 GiB each way and both at once;
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
               scaled_dot_product_attention's time (the forward also at
               S 8192, 4 heads: the long-sequence contract of the TPU's
               chunked forward). The redesigned kernels' rows add three
               reruns bit for bit and a variant on the same inputs: the
               flash forward with the other setting of its warpgroups'
               turns (``other_turns_us``), matvec_stacked's CUDA-core
               kernel (``fma_us``, held to the same limit);
3. serve    — ``serving.build_engine`` with GPT-2 large at full width and
               depth (random weights from seed 0) serving 16 greedy
               requests through 8 slots; every kernel's launch count over
               that run, TTFT, generated tokens/s over the serve's wall
               time, decode-only tokens/s over the ticks' time, and the
               decode step time beside its floor (the layer weights and
               LM head read once, plus the live K/V rows the step's
               slots attend over); a teacher-forced check of every
               request against a dense forward of the plain versions;
   gpt2_generate_init, kernel, generate_gpt2 — after the serve engine is
               freed, GPT-2 large at bench.py's bench_decode config (vocab
               50304, ctx 2048, random weights from seed 0, quantized to
               int8 codes on the card): the unstacked int8 kernels
               (ln_qkv_int8, out_ffn_int8, decode_attention_int8 over an
               int8 cache at ctx 2048 with the scales past the position
               NaN, kv_quant_int8 into it; matvec_int8, which no model
               calls: path null, no launches) and the fast route's stacked
               kernels (ln_qkv_stacked, out_ffn_stacked and
               decode_attention_stacked over the int8 codes and cache with
               kv_quant_int8, and over the bf16 weights and a bf16 cache),
               each held at B 1 and 8 and timed at its route's batch, and
               decode_pos_sweep: decode attention at pos 0, a page's edge,
               every split boundary +-1 and the last key (stacked bf16
               and int8 caches at B 1 and 8, paged pools); then
               generate()'s five cases timed as bench_decode times them
               (b1 fast route bf16 and int8/int8, b1 and b8 per-token
               route int8/int8, b8 bf16 weights with an int8 cache),
               exact launches per path, the last row of each batch
               teacher-forced against the fp32 dense oracle, and the
               positions where the fast and per-token routes part;
   gpt2_int8_init, kernel, serve_gpt2_int8 — the serve phase again with
               quantize_bits 8 and kv_cache_bits 8: the int8 branches of
               ln_qkv_stacked and out_ffn_stacked and paged attention over
               the int8 pool at head dim 64, then the 16 requests, checked
               against the fp32 int8 oracle;
   llama_init, kernel, serve_llama — the same for LLaMA-7B (E 4096, 32
               layers, 32 heads of 128, F 11008, vocab 32000, bf16,
               random weights from seed 0, LLAMA_INIT_STD) after the
               GPT-2 engine is
               freed: its five kernels at their shapes (RMSNorm ln_qkv,
               matvec_stacked for the o-projection beside torch.matmul,
               SwiGLU out_ffn with fuse_proj=False, head-dim-128 paged
               attention, also at LLaMA-3-8B's GQA geometry, and the
               head-dim-128 flash forward beside SDPA), then the same 16
               requests through 8 slots;
   llama_int8_init, kernel, serve_llama_int8 — after the bf16 engine is
               freed, the engine built with quantize_bits 8 (the seed-0
               weights quantized to int8 codes on the card) and
               kv_cache_bits 8 (the int8 pool): its int8 kernels (ln_qkv,
               matvec_stacked, out_ffn, paged attention over the int8
               pool, also at LLaMA-3-8B's GQA geometry, and kv_quant_int8
               held bit for bit), then the same 16 requests, checked
               against the fp32 dense pass over the int8 weights whose
               decode steps attend over K/V rounded through the pool's
               codes, with the decode step's floor counting int8 weights
               and K/V rows;
   kernel, generate_llama_int8 — ``llama_fast_generate`` over the same
               int8 weights: the flash forward at its b8 prompt pass's
               shape (B 8, S 2048, causal; its planted fault: every batch
               element given element 0's K/V) beside SDPA,
               decode_attention_stacked over an int8 and a bf16 cache of
               8 rows at ctx 2048 (scales past the position NaN) and
               kv_quant_int8 into the int8 cache, and decode_pos_sweep at
               LLaMA-7B's widths (B 1, split 8 ways, and 8); then b1 and
               b8 at ctx
               2048 (prompts of 1968 tokens) timed as bench.py's
               bench_llama_decode times them, decode tokens/s beside the
               floor, the last row of each batch teacher-forced, and a
               short b8 case over a bf16 cache (kv_cache_bits 0);
4. kernel    — the flash kernels at the training shape (B=8, H=20,
               S=1024, D=64, causal): the forward (its planted fault:
               every batch element given element 0's K/V) beside SDPA,
               and the backward's two kernels (the delta reduction and
               the single-pass dq/dk/dv kernel), also at S=8192 and not
               causal, beside a planted fault each (the last q tile's
               contribution dropped from dk/dv, the first key tile from
               dq, one position's delta), three reruns bit for bit and
               SDPA's backward (eager, and by CUDA-graph replay) as the
               library time; a flash_backward line with the delta
               expression the delta kernel replaces and the whole
               backward against its bound;
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
               that the limit must reject;
7. kernel, train_llama, llama_generate, llama_grad_check — the flash
               kernels' rows again at LLaMA-7B's training attention (B 4,
               32 heads, S 2048, D 128, causal; path train_llama); then
               ``initialize`` of LlamaForCausalLM at LLaMA-7B's width
               (E 4096, 32 heads of 128, F 11008, vocab 32000) cut to
               LLAMA_LAYERS (16) layers, full-block remat, chunked loss
               over the untied head, the train config above, and 2
               warm-up + 10 timed ``train_batch`` steps on one seeded
               batch of 4 x 2048: step time, tokens/s, model TFLOP/s
               ((6·N' + 12·L·S·E)·tokens, N' without the embedding
               table), MFU, the floor, peak memory, every loss (finite,
               falling) and exactly 2·L flash forward launches a step (the
               recompute runs the forward again) and L of each backward
               kernel; ``llama_generate`` (B 1, a 32-token prompt, 16
               greedy new tokens: no hand-written kernel, plain PyTorch
               as JAX's dot_generals) with the trained model, every token
               teacher-forced within TF_ULPS against the same weights'
               bf16 forward without the cache, and, after the engine is
               freed, with a fresh 16-layer model at LLAMA_INIT_STD, held
               also against its fp32 forward (the gaps against the flash
               forward printed beside), and its tokens/s; then the GPT-2
               grad check's comparison at 2
               layers of LLaMA-7B's width (2 x 2048) and of LLaMA-3-8B's
               (GQA: 8 KV heads, F 14336, vocab 128256; 1 x 2048), each
               with its planted fault, every leaf at GRAD_RTOL but the
               untied lm_head (LLAMA_LEAF_RTOL), and what the
               GQA backward's repeat-and-sum costs at LLaMA-3-8B's
               attention;
   train_llama_offload, train_llama_offload_host, offload_parity,
   train_nvme — all 32 layers of LLaMA-7B (4 x 2048, remat) with the
               optimizer state off the card: the streamed tier (67.4 GB
               pinned, the update streamed through the card) and the
               host runner (80.9 GB, the native SIMD Adam), warm-up and
               timed steps (2L / L / L flash launches a step), step ms,
               MFU, each step's fwd+bwd and update device ms (CUDA
               events) with host seconds beside them, the transfer bound,
               device peak and host GB; both tiers' losses and each
               master leaf's update against the device optimizer's at 2
               layers, beside a planted fault (one leaf at twice the
               lr); GPT-2 large with its moments and parameters on the
               host's disk (a fresh temporary directory), its losses
               against the train phase's first ones;
   kernel, train_infinity, infinity_restore, infinity_parity, nvme_xl,
   param_offload — the flash rows at the ZeRO-Infinity path's shape
               (B 4, H 32, S 1024, D 128); bench.py's 6.25B GPT-2 (E
               4096, 30 layers) through the InfinityEngine, its state
               pinned in host memory and its bf16 parameters on the
               disk, 6 segments, 1 + 3 steps (2L / L / L flash launches
               a step, each step against its transfer bound); a fresh
               engine restored from the parked files; 2 layers at K 1
               against K 2 and against the main engine's first update,
               with planted faults; 10.64B bf16 leaves parked under
               O_DIRECT and twice re-streamed (host RSS growth under 1
               GiB); GPT-2 large with offload_param cpu and nvme, bit
               for bit against the plain engine;
8. kernel, bert_kernels — the three block-sparse kernels (forward, dq,
               dk/dv) at BERT's main shape (B 4, H 16, S 4096, D 64,
               block 16, the per-head Fixed layout of the config below:
               16 tables, density 0.262), a shared BigBird layout at
               block 64 (one collapsed table) and a layout with an empty
               row, each held against its plain version; a planted fault
               each at the main shape (a k-block left out of one row's
               table, a q-block out of one column's); timed there beside
               the plain versions, SDPA over the layout expanded to a
               boolean mask (forward; forward + backward for the
               backward rows) and the port's dense non-causal flash
               forward + backward (bench.py's bench_sparse_attention
               comparison); each row with its work list's size (tiles,
               steps, the longest tile's steps) and three reruns bit for
               bit; bounds of 4, 6 and 8 block²·D flops a listed block
               pair (2, 3 and 4 products);
9. train_bert_sparse — the GPT-2 engine freed, ``initialize`` of
               BertForPreTraining at BERT-large's full width and depth
               (E 1024, 24 layers, 16 heads of 64, vocab 30522; bf16
               compute, fp32 masters, Adam lr 1e-4 as bench.py's
               bench_bert) with DeepSpeed's documented sparse_attention
               block (fixed, block 16, 4 local, 1 global, 4 patterns per
               head) turned into the layout by config_to_sparsity +
               sparse_config_for; seeded weights of 512 positions
               extended to 4096 (extend_position_embedding); 2 warm-up +
               10 timed ``train_batch`` steps on 4 x 4096 tokens with 15 %
               MLM and NSP labels and no attention_mask: step time,
               tokens and sequences/s, model TFLOP/s (6N per token plus
               12·L·B·(active blocks)·block²·D of attention), MFU, peak
               memory, every step's loss (finite, falling), and exactly
               24 launches a step of each block-sparse kernel (none of
               flash or of the masked-dense path);
10. bert_grad_check — a 2-layer BERT of the same width and layout config
               at 16 x 256 tokens: loss and every gradient leaf through
               the kernels against the plain versions, and a planted
               fault (the last k-block of every row left out of dq);
11. kernel (quantize) — the grouped quantize kernel on the MoQ paths'
               shapes: c_fc [1280, 5120] fp32 in 8 groups at 15 and 8
               bits, wte [50304, 1280] in 8 groups, a bf16 input, and
               train_moq_sr's leaf set (wte, wpe and the stacked [36, .]
               leaves, 8 groups, asymmetric); nearest bit for bit against
               the plain version beside a planted fault (one scale over
               the whole tensor; the last R tile of each group left out
               of the reduction); stochastic (symmetric 8 bits on c_fc,
               asymmetric 15 bits on each leaf shape of train_moq_sr)
               over 256 draws of values at known fractions of a step in
               8 groups (codes floor or ceil, the summed error within 4
               sigma; the fault u = 0.5 fails), and over every code
               against the plain version's draws; each timed in place by
               CUDA-graph replay, bounded by its bytes; then a whole
               train_moq boundary as ONE launch over the table of its 146
               leaves: each leaf bit for bit at 15 and 12 bits (both
               faults, an outlier at each group's end), timed against
               1.85 ms beside one copy_ of the same bytes and its host
               time; and a whole train_moq_sr boundary as one launch (10
               leaves, the stacked ones as 36 pieces, the blend at 0.75):
               bit for bit with nearest rounding, timed stochastic;
12. train_moq — ``initialize`` of GPT-2 large in the unrolled layout with
               DeepSpeed's MoQ tutorial block (start 16, target 8, 8
               groups, symmetric, period cut to 6) and 2 + 10
               ``train_batch`` steps: the bits JAX's Quantizer gives
               (15 → 12), exactly 1 quantize launch a step (146 leaves)
               and no call of the plain version, each boundary's device
               time (CUDA events) against its bound and host time, step
               time, MFU, peak memory; after the last step at most 2^12
               values in every group of wte, h.0 c_fc and h.35 mlp
               c_proj, and the bf16 copy equal to the masters;
13. train_moq_sr — the scan layout (MoQ quantizes wte, wpe and the 8
               stacked bias and LayerNorm leaves: 1 launch a step over
               their 290 pieces) with asymmetric stochastic rounding, the
               blend (ratio 0.75 → 0) inside the kernel and progressive
               layer drop, 2 + 3 steps, each boundary's device time
               against its bound and host time;
14. kernel, zero3_kernels — ag_matmul (forward and dx),
               mm_rs_partial and mm_rs_reduce at GPT-2 large's four
               projections cut into 4 shards, M 2048 (a rank's 2 x 1024
               tokens), the four "peers" local tensors in this process:
               every rank's output held against the plain version, a
               planted fault each (a chunk read from the wrong rank, a
               chunk written into its neighbour's slot), timed beside
               torch.matmul and beside the mma.sync kernel of the shapes
               TMA cannot describe (mma_us), with each row's tile walk
               (tile, tiles, grid, waves); then the rows' summed times by
               kernel, the mma.sync kernels' included;
15. zero3_grad_check, train_zero3_fused, train_zero3_ring — four ranks
               started on the one card (``parallel.mesh.spawn``, gloo,
               each rank's shards in a symmetric heap its peers map
               through CUDA IPC): a 2-layer full-width model's gradients
               through the fused kernels against their plain versions,
               with a planted fault; then ``initialize(mesh=...)`` of
               GPT-2 large under ZeRO stage 3 with ``stage3_prefetch``
               and 2 + 4 ``train_batch`` steps of the train cell's batch
               (2 x 1024 a rank), gathers ``fused_matmul`` then ``ring``:
               step time, barriers a step and the host time in them,
               each rank's peak memory and heap, launches a step a rank
               against the design (432 ag_matmul, 144 of each
               mm_rs kernel, all by the TMA kernels: 0 ag_matmul_mma and
               0 mm_rs_partial_mma), losses finite, falling from the first
               timed step, within ZERO3_LOSS_RTOL (3e-3) of each other and
               of the one-card train phase's. The ranks time-share the card: no
               multi-GPU number.
16. kernel, zero2_kernels — mm_rs_reduce as the ZeRO stage 0-2 bucket
               stream runs it: the first and the last bucket of GPT-2
               large's default plan (``plan_buckets``, reduce_bucket_size
               5e8, four ranks: 498.6M and 275.5M elements), the four
               "peers" local [4, run] fp32 regions in this process, every
               rank's chunk held bit for bit against mm_rs_reduce_plain
               with a planted fault (one peer's region read from the
               wrong rank), timed beside its bound and torch.sum over the
               same rows; the flash rows at B 2 are train_zero3_fused's,
               the same shapes, carried to path "train_zero2";
17. train_zero2, zero2_restore — four ranks on the one card:
               ``initialize(mesh=...)`` of GPT-2 large at ZeRO stage 2
               with overlap_comm and the default bucket, the train cell's
               model, config and batch (2 x 1024 a rank), 2 + 4 steps:
               step time and its split (exchange, update, gather), the
               barriers a step and the host time in them, buckets a
               step, each rank's peak memory and heap, launches a step a
               rank against the design (one mm_rs_reduce a bucket, 0
               calls of its plain version, the flash kernels as on one
               card), losses finite, falling from the first timed step,
               within ZERO3_LOSS_RTOL of train_zero3_ring's and of the
               one-card train phase's, and a planted fault
               (own_slot_only) beyond it; then a save at four ranks,
               loaded by fresh four-rank engines whose next loss must
               equal the uninterrupted run's bit for bit, and by one
               rank, within ZERO3_LOSS_RTOL.

Each path counts its kernels' launches from 0 just before its run: each
serve run for the decode kernels and the prefill forward, the fast
path's timed runs (and its bf16-cache run) for its kernels, each
generate() case's timed runs, the train runs (GPT-2's, LLaMA's) for the
flash kernels, the BERT train run for the block-sparse kernels, each MoQ
run's timed steps for quantize, rank 0's fused_matmul timed steps for the fused
collective kernels, rank 0's stage-2 timed steps for mm_rs_reduce and
the flash kernels on "train_zero2". A kernel has a row for each
path it runs on ("serve", "serve_gpt2_int8", "generate_gpt2",
"generate_gpt2_bf16", "generate_gpt2_step", "serve_llama",
"serve_llama_int8", "generate_llama", "generate_llama_kv0", "train",
"train_llama", "train_bert_sparse", "train_moq", "train_moq_sr",
"train_zero3_fused", "train_zero2");
each row of the
kernels line is timed and bounded at its path's shapes and carries that path's launches (matvec_int8's
row: no path, 0). "generate_gpt2_kv8" (bf16 weights, an
int8 cache, B 8) runs decode_attention_int8 alone, at the shape of its
generate_gpt2_step row; its launches are checked exactly in its case.

With ``--profile`` each serve is repeated under torch.profiler (device
time by kernel name, the device's idle share, the torch ops' host time)
and cProfile (the host's Python by function), one b1 run of each fast
path (LLaMA's, GPT-2's int8), three train steps, three LLaMA train
steps and three BERT steps under torch.profiler, and three MoQ steps.

It then prints the nvidia-smi line, a ``kernels`` JSON line and, last,
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
nonzero and the last line is not printed. Without a CUDA device it exits
with code 2 before doing anything.
"""

import cProfile
import dataclasses
import gc
import itertools
import json
import math
import os
import pstats
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12        # fp32 outside the tensor cores
LAYER = 17
# teacher-forced check: the plain logit of the engine's token may sit at
# most this many bf16 units in the last place (of the position's top
# logit, 0.0156 for a top logit of 2-4) below the plain maximum. Logits
# are bf16, so a near tie may break the other way by a unit or two; the
# top-2 spacing of these random-weight logits is ~8 units, so a decoder
# that takes the runner-up fails.
TF_ULPS = 3
N_REQUESTS = 16
# every serving path: 8 slots of up to 64 pages of 16 tokens
SERVING = {"slots": 8, "page_size": 16, "max_pages_per_slot": 64}
# int8 serving (both families): the weights quantized when the engine is
# built, the int8 pool
SERVING_INT8 = {**SERVING, "quantize_bits": 8, "kv_cache_bits": 8}
# llama_fast_generate as bench.py's bench_llama_decode runs it: ctx 2048,
# prompts of ctx - 80 tokens, decode tokens/s from t(68 new) - t(4 new);
# and a short bf16-cache case
GEN_CTX, GEN_BATCHES, GEN_SHORT, GEN_LONG = 2048, (1, 8), 4, 68
GEN_KV0 = {"batch": 8, "prompt": 240, "new": 16}
# GPT-2 large generate() at bench.py's bench_decode cases: (name, batch,
# quantize_bits, kv_cache_bits, scan_decode, path): the default fast route
# (the stacked kernels) in bf16 and int8/int8, and the per-token route
# (the fused layer's unstacked int8 kernels; with bf16 weights and an
# int8 cache decode_attention_int8 alone)
GPT2_GEN_CASES = (
    ("b1_bf16_fast", 1, 0, 0, True, "generate_gpt2_bf16"),
    ("b1_int8_fast", 1, 8, 8, True, "generate_gpt2"),
    ("b1_int8_step", 1, 8, 8, False, "generate_gpt2_step"),
    ("b8_int8_step", 8, 8, 8, False, "generate_gpt2_step"),
    ("b8_bf16w_kv8_step", 8, 0, 8, False, "generate_gpt2_kv8"))
# LLaMA-7B's random weights: N(0, std) with std * sqrt(E) = 0.02 *
# sqrt(1280), the pre-activation scale of GPT-2 large's init. At flax's
# std 0.02 the random model's attention scores have a std of ~1.6, and
# bf16 rounding differences grow over its 32 layers until the paged
# decode parts from a dense forward by 10-11 bf16 units, through the
# plain versions as through the kernels and against a bf16 or an fp32
# dense pass alike (tests/perf/torch_llama_teacher_forced.py): the
# teacher-forced check could not tell a fault from rounding. At this std
# both stay within 3 units of the fp32 dense pass, the LLaMA oracle
LLAMA_INIT_STD = 0.02 * math.sqrt(1280 / 4096)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_VOCAB = 8, 1024, 50304
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# LLaMA-7B training at its full width and half its depth: 32 -> 16 layers,
# as its training state (fp32 masters, bf16 compute copy, grads and
# exp_avg, fp32 exp_avg_sq: 14 bytes a parameter) takes ~94 GB at 32 and
# ~49 GB at 16 of the card's 80; 4 x 2048 tokens, full-block remat, the
# loss in chunks of 2048 tokens over the untied head
LLAMA_BATCH, LLAMA_SEQ, LLAMA_LAYERS, LLAMA_LOSS_CHUNK = 4, 2048, 16, 2048
# LLaMA-7B training with the optimizer state off the card (ZeRO-Offload):
# all 32 layers. The card keeps the bf16 parameters and gradients (~27 GB)
# and the remat activations; the streamed tier pins 10 bytes a parameter
# in host memory (67.4 GB: fp32 master, bf16 exp_avg, fp32 exp_avg_sq),
# the host runner keeps 12 (80.9 GB, fp32 moments) of the host's ~106 GB
LLAMA_OFFLOAD_LAYERS, LLAMA_OFFLOAD_REDUCED = 32, "none"
# ZeRO-Infinity on GPT-2 large: the moments and the parameters on the
# disk of the card's host (a fresh temporary directory), 1 + NVME_STEPS
# steps against the train phase's first ones; O_DIRECT asked for (a
# filesystem that refuses it latches the run to buffered I/O, and the
# line says so)
NVME_STEPS = 2
NVME_AIO = {"block_size": 1 << 20, "queue_depth": 8, "thread_count": 8,
            "o_direct": True}
# ZeRO-Infinity, the JAX package's scale proof (bench.py:1370
# bench_infinity_6b): GPT-2 at E 4096, 30 layers, 32 heads (6.25B), its
# state pinned in host memory (fp32 master, bf16 exp_avg, fp32
# exp_avg_sq: 62.5 GB), the bf16 parameters on the disk, 6 segments of 5
# layers, 4 x 1024 tokens, 1 + INF_STEPS steps, at full depth
INF_E, INF_LAYERS, INF_HEADS, INF_SEGMENTS = 4096, 30, 32, 6
INF_BATCH, INF_SEQ, INF_STEPS = 4, 1024, 3
# nvme_xl (bench.py:1905): GPT-2 leaf shapes at E 5120 and 33 layers
XL_E, XL_LAYERS = 5120, 33
# llama_generate with the trained model: B 1, a 32-token prompt, 16 new
LLAMA_GEN_PROMPT, LLAMA_GEN_NEW = 32, 16
# full-width 2-layer gradient check: row-relative limit per leaf, kernels
# against plain versions (both bf16 end to end); measured on an H100
# 9.0e-3 at most (wpe), 6.4e-3 median over the 28 leaves
GRAD_RTOL = 3e-2
# the same check's fp32 losses, relative: measured on an H100 1.2e-5
# (11.07650 against 11.07636)
LOSS_RTOL = 1e-3
# the LLaMA grad checks (2 layers at LLaMA-7B's width, 2 x 2048 tokens;
# at LLaMA-3-8B's, GQA, 1 x 2048) hold every leaf at GRAD_RTOL but the
# untied lm_head, which has its own limit: measured on an H100 0.0318 and
# 0.0356 there (the rows of the ~3/4 of the vocabulary absent from the
# labels are sums of p·x over the tokens, small beside the others, where
# the hidden states' bf16 differences show at full size); every other
# leaf within 0.0211; medians 0.0131 and 0.0133; the planted fault 0.600
# and 0.630 (q_proj)
LLAMA_LEAF_RTOL = {"lm_head": 5e-2}
# the BERT grad check (2 layers at BERT-large's width, 16 x 256 tokens):
# each row is measured against at least BERT_GRAD_FLOOR of its leaf's RMS
# row norm, since the pooler's and the NSP head's kernels are sums of 16
# outer products of one token's vectors, whose rows near 0 carry bf16
# rounding at the size of the others. Measured on an H100 at this floor:
# 0.066 at most (seq_relationship.kernel), 0.035 in the FFN kernels,
# 0.013 median over 38 leaves; the planted fault 0.25 (attn_qkvw). At
# GPT-2's floor 1e-3 the NSP kernel alone reached 0.36-0.39; with the
# main path's 4096 tokens in one row the fault (one of 67 blocks a row)
# fell under the error
BERT_GRAD_FLOOR = 0.3
BERT_GRAD_RTOL = 0.12
# BERT-large pretraining with block-sparse attention: DeepSpeed's
# documented sparse_attention example, bench.py's bench_bert optimizer
# (Adam, lr 1e-4, bf16), positions 512 extended to 4096, 4 x 4096 tokens
BERT_SPARSE = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
               "num_local_blocks": 4, "num_global_blocks": 1,
               "attention": "bidirectional",
               "horizontal_global_attention": False,
               "num_different_global_patterns": 4}
BERT_BATCH, BERT_SEQ, BERT_POSITIONS = 4, 4096, 512
BERT_WARMUP, BERT_STEPS = 2, 10
BLOCKSPARSE_KERNELS = ("blocksparse_fwd", "blocksparse_bwd_dq",
                       "blocksparse_bwd_dkv")
# the flash kernels a training step launches once a layer each
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                 "flash_attention_bwd_delta")
# MoQ training: DeepSpeed's MoQ tutorial block (start 16 bits, target 8,
# 8 groups, symmetric nearest) with its period cut from 400 to 6 so that
# the precision falls within the run; the bits JAX's Quantizer gives at
# each of the 2 + 10 steps
MOQ = {"enabled": True,
       "quantize_bits": {"start_bits": 16, "target_bits": 8},
       "quantize_schedule": {"quantize_period": 6, "schedule_offset": 0},
       "quantize_groups": 8,
       "quantize_algo": {"q_type": "symmetric", "rounding": "nearest"}}
MOQ_SCHEDULE = [15, 14, 14, 13, 13, 13, 13, 12, 12, 12, 12, 12]
# the other variants with progressive layer drop (DeepSpeed's PLD
# tutorial: theta 0.5, gamma 0.001) on the scan layout, 2 + 3 steps, the
# blend ratio after each
MOQ_SR_WARMUP, MOQ_SR_STEPS = 2, 3
MOQ_SR_RATIOS = [0.75, 0.5, 0.25, 0.0, 0.0]
PLD = {"enabled": True, "theta": 0.5, "gamma": 0.001}
# stochastic rounding held statistically: draws of a vector at known
# fractions of a step; the summed code error within SR_Z sigma of 0
SR_DRAWS, SR_Z = 256, 4.0
# the train profile's kernel groups, by words in the kernel's name
# (first match wins)
TRAIN_KERNEL_GROUPS = (
    ("blocksparse_dkv", ("bs_dkv",)),
    ("blocksparse_dq", ("bs_rows_tma_kernel<true>",
                        "bs_rows_tma_kernelILb1")),
    ("blocksparse_fwd", ("bs_rows_tma_kernel<false>",
                         "bs_rows_tma_kernelILb0")),
    ("flash_bwd_delta", ("flash_bwd_delta",)),
    ("flash_bwd", ("flash_bwd",)),
    ("flash_fwd", ("flash_fwd",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("copies and casts", ("copy_kernel", "direct_copy", "cat")),
    ("layer norm", ("layer_norm",)),
    ("reductions", ("reduce_kernel", "softmax", "logsumexp")),
    ("embedding", ("embedding", "index")),
    ("elementwise", ("elementwise",)))


# ZeRO-3 over four ranks sharing the one card (each rank's shards in a
# symmetric heap its peers map through CUDA IPC): GPT-2 large, bf16, the
# training cell's batch of 8 x 1024 cut into 2 x 1024 a rank, 2 + 4 steps
# under stage3_prefetch_gather fused_matmul, then the same in ring mode
# (the train cell's loss oscillates over its first five steps, 11.08 ..
# 11.16, and falls from the sixth)
ZERO3_RANKS, ZERO3_WARMUP, ZERO3_STEPS = 4, 2, 4
ZERO3_KERNELS = ("ag_matmul", "mm_rs_partial", "mm_rs_reduce")
# the mma.sync kernels that take the shapes TMA cannot describe: timed
# beside the TMA kernels, launched 0 times on the main path
ZERO3_MMA_KERNELS = ("ag_matmul_mma", "mm_rs_partial_mma")
# the four projections of a block: (leaf, in, out, the dim their stage-3
# shard cuts in a layer's coordinates)
ZERO3_LEAVES = (("attn.c_attn", 1280, 3840, 1), ("attn.c_proj", 1280, 1280, 0),
                ("mlp.c_fc", 1280, 5120, 1), ("mlp.c_proj", 5120, 1280, 0))
# the rank whose kernel calls are timed (its ring starts off chunk 0)
ZERO3_TIMED_RANK = 1
# a GPT-2 large layer's packed group under fused_matmul: the c_attn and
# c_fc biases' shards ([36, 3840] and [36, 5120] are cut at the default
# persistence threshold, the [36, 1280] leaves stay replicated)
ZERO3_GROUP = (3840 + 5120) // 4
# fused_matmul's losses against ring mode's, and both against the one-card
# train phase's first steps (same model, seed, batch and config): the
# fused path rounds each projection to bf16 before its bias and sums dW
# once in fp32, the ring path adds the bias inside the product and sums
# the ranks' bf16 dW in fp32, one card sums the whole batch's dW: bf16
# rounding apart, relative. Measured on an H100 over the 2 + 4 steps:
# fused_matmul 1.06e-3 from ring and 9.9e-4 from one card, ring 7.6e-5
# from one card; the planted fault (own_slot_only) 7.6e-2 (2.9e-3 at step
# 2, 2.1e-2 at step 3)
ZERO3_LOSS_RTOL = 3e-3
# the one-card train phase's losses, for the ZeRO-3 runs to be held to
TRAIN_LOSSES = []
# ZeRO stage 2 over the same four ranks: the train cell's config at stage
# 2 with overlap_comm and the default reduce_bucket_size (5e8 elements),
# which cuts GPT-2 large's 774.1M parameters, in the model's order, into
# two buckets (498.6M, 275.5M); held to train_zero3_ring's losses (and
# the one-card train phase's) at ZERO3_LOSS_RTOL
ZERO2_BUCKET = int(5e8)
ZERO3_RING_LOSSES = []


_CLOCK = [time.perf_counter()]


def emit(obj):
    """Print one JSON line. A phase line gets ``seconds``: the wall time
    since the previous phase line (the first: since the script began)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = dict(obj, seconds=now - _CLOCK[0])
        _CLOCK[0] = now
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops, rate=BF16_FLOP_PER_S):
    """(ms, what bounds it) for the least time the card could take: the
    bytes over the memory rate or the operations over ``rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
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
    same inputs, which must be beyond it (or None). ``name`` is the
    limit's key in ``tolerance.ROW_RTOL`` (``kernel[variant]`` for a
    variant)."""
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


def _source(name):
    """The CUDA source of a kernel, by its wrapper's name."""
    if "flash" in name:
        return "flash_attention"
    if name == "quantize":
        return "quantize"
    if name in ZERO3_KERNELS:
        return "fused_collective"
    return "blocksparse" if "blocksparse" in name else "decode"


def bit_equal_reruns(name, fn):
    """A kernel whose stage ring raced would give other bits on a rerun:
    three reruns must equal the first call bit for bit."""
    def outs():
        got = fn()
        return got if isinstance(got, tuple) else (got,)
    first = outs()
    for _ in range(3):
        if not all(torch.equal(a, b) for a, b in zip(first, outs())):
            raise AssertionError(f"{name}: reruns differ from the first")
    return first


def proj_extra(name, fn, B, wb, launches, matmul=None, n=36):
    """What a decode projection row adds: three reruns bit for bit (the
    cluster sums its partials in a fixed order) and the launch plan of
    each of the call's launches ``(K, N, prologue[, pair])`` over
    ``wb``-byte weights at B slots and the card's SM count; and, where
    ``matmul(i)`` is given (the LLaMA-7B bf16 rows), the device time of
    torch.matmul of the bare projection(s) at layer i, a yardstick of the
    weight stream alone (not the table's library column: no PyTorch call
    computes the norm, the products and the epilogue)."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    bit_equal_reruns(name, fn)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    extra = {"reruns_bit_equal": True,
             "plan": [dk.matvec_tma_plan(B, K, N, wb, sms, *rest)._asdict()
                      for K, N, *rest in launches]}
    if matmul is not None:
        extra["matmul_us"] = 1e3 * time_graph_ms(matmul, n=n)
    return extra


def gpt2_ffn_launches(E, F):
    """GPT-2's out_ffn launches (K, N, prologue): x1, h, out."""
    return [(E, E, "copy"), (E, F, "ln_f32"), (F, E, "copy")]


def llama_ffn_launches(E, F, wb):
    """LLaMA's out_ffn launches over ``wb``-byte weights: the paired
    gate/up, then down."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    return [(E, F, "rms_bf16", dk.GLU_PAIRING[wb]), (F, E, "copy")]


def attn_plan(name, fn, q, capacity):
    """What a decode attention row adds: the split plan its launch takes
    at the card's SM count (``n_split`` blocks a (KV head, slot), one
    cluster, of ``chunk`` keys each) and three reruns bit for bit (the
    splits merge in a fixed order)."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    bit_equal_reruns(name, fn)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = dk.decode_split_plan(q.shape[0], q.shape[1], capacity, sms)
    return {"n_split": plan.n_split, "chunk": plan.chunk,
            "reruns_bit_equal": True}


def pos_sweep(name, kernel, plain, q, capacity, key, nan_past=()):
    """decode attention at pos 0, a page's last key and the next, every
    split boundary +-1 of the launch's plan and the capacity's last key:
    each held against its plain version at ``key``'s limit, finite where
    ``nan_past`` (scale tensors) is NaN past pos, and rerun bit for bit.
    ``kernel(pos)`` / ``plain(pos)`` take a one-element int32 tensor."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    from deepspeed_tpu_torch.ops.cuda import tolerance
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = dk.decode_split_plan(q.shape[0], q.shape[1], capacity, sms)
    ps = {0, 15, 16, capacity - 1}
    for s in range(1, plan.n_split):
        ps |= {s * plan.chunk - 1, s * plan.chunk, s * plan.chunk + 1}
    errs = []
    for p_ in sorted(x for x in ps if 0 <= x < capacity):
        keep = [t.clone() for t in nan_past]
        for t in nan_past:
            t[..., p_ + 1:] = float("nan")
        pos = torch.tensor([p_], dtype=torch.int32, device=q.device)
        got = kernel(pos)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: read past pos {p_}")
        if not torch.equal(got, kernel(pos)):
            raise AssertionError(f"{name}: a rerun differs at pos {p_}")
        errs.append((p_, tolerance.check_kernel(key, got, plain(pos))))
        for t, k in zip(nan_past, keep):
            t.copy_(k)
    return {"kernel": name, "limit": key, "n_split": plan.n_split,
            "chunk": plan.chunk, "pos": [e[0] for e in errs],
            "row_rel_err_max": max(e[1] for e in errs)}


def random_cache(shape, int8, gen, dev):
    """(k, v, scales) of a random cache [.., rows, D]: bf16 values, or
    int8 codes with fp32 scales [.., 1, rows] as the kernels take them."""
    if not int8:
        return (*(torch.randn(shape, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2)), {})
    codes = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    sshape = shape[:-2] + (1, shape[-2])
    return (*codes, {n: torch.rand(sshape, generator=gen, device=dev) * 0.01
                     + 0.002 for n in ("k_scale", "v_scale")})


def decode_pos_sweeps(dev, gen, label, H, R, D, Bs=(1, 8), L=GEN_CTX):
    """The pos sweep of decode_attention_stacked over bf16 and int8 caches
    (NaN scales past pos) at B in ``Bs``, and of decode_attention_paged
    over a bf16 and an int8 pool of 8 slots (64 pages of 16, scattered;
    slot b at pos + b), at one model's widths (``label``): one phase
    line."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    rows = []
    lid = torch.tensor(0, dtype=torch.int32, device=dev)
    for B in Bs:
        q = torch.randn(B, H, R, D, generator=gen, device=dev).to(
            torch.bfloat16)
        for int8 in (False, True):
            kc, vc, kw = random_cache((1, B, H, L, D), int8, gen, dev)
            key = "decode_attention_stacked" + ("[int8]" if int8 else "")
            rows.append(dict(pos_sweep(
                "decode_attention_stacked",
                lambda pos: dk.decode_attention_stacked(q, kc, vc, pos, lid,
                                                        **kw),
                lambda pos: dk.decode_attention_stacked_plain(
                    q, kc, vc, pos, 0, **kw), q, L, key,
                tuple(kw.values())), B=B, cache="int8" if int8 else "bf16"))
            del kc, vc, kw
    B, page, maxp = 8, 16, 64
    NB, cap = B * maxp + 1, maxp * page
    pt = (torch.randperm(NB - 1, generator=gen, device=dev)[:B * maxp] + 1
          ).reshape(B, maxp).to(torch.int32)
    q = torch.randn(B, H, R, D, generator=gen, device=dev).to(torch.bfloat16)
    step = torch.arange(B, dtype=torch.int32, device=dev)
    for int8 in (False, True):
        kc, vc, kw = random_cache((1, NB, H, page, D), int8, gen, dev)
        rows.append(dict(pos_sweep(
            "decode_attention_paged",
            lambda pos: dk.decode_attention_paged(
                q, kc, vc, (pos + step).clamp(max=cap - 1), pt, lid, **kw),
            lambda pos: dk.decode_attention_paged_plain(
                q, kc, vc, (pos + step).clamp(max=cap - 1), pt, 0, **kw),
            q, cap, "decode_attention_paged" + ("[int8]" if int8 else "")),
            B=B, pool="int8" if int8 else "bf16"))
        del kc, vc, kw
    emit({"phase": "decode_pos_sweep", "model": label, "H": H, "R": R,
          "D": D, "L": L, "cases": rows})
    torch.cuda.empty_cache()


def flash_variants(q, k, v, causal, n):
    """What a flash forward row adds: three reruns bit for bit, and the
    kernel with the other setting of its warpgroups' turns (``PINGPONG``
    by head dim), equal to it bit for bit and timed the same way
    (``turns``: the row's setting; ``other_turns_us``: the other's)."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    def call(i=0):
        return fa.flash_attention_fwd(q, k, v, causal=causal)
    first = bit_equal_reruns("flash_attention_fwd", call)
    D, keep = q.shape[-1], dict(fa.PINGPONG)
    fa.PINGPONG = {**keep, D: not keep[D]}
    try:
        other = call()
        ms = time_graph_ms(call, n=n)
    finally:
        fa.PINGPONG = keep
    if not all(torch.equal(a, b) for a, b in zip(first, other)):
        raise AssertionError("flash_attention_fwd: the kernel with the other "
                             "turn setting differs")
    return {"turns": keep[D], "other_turns_us": ms * 1e3,
            "reruns_bit_equal": True}


def record(results, name, path, replaces, checks, ms, call_ms, plain_ms,
           bound_ms_by, cases, fault, library_ms=None, lse_err=None,
           limit=None, extra=None):
    """Append a kernel's row to ``results`` and print its kernel line.
    ``path`` is the main path ("serve", "serve_llama" or "train") whose
    shapes the row was timed and bounded at, and whose run its launches
    are counted in. ``checks``: (max abs error, row-relative error,
    planted fault's row-relative error or None) per case; ``limit``: the
    key of the limit they were held to (default ``name``); ``extra``:
    more keys for the kernel line."""
    from deepspeed_tpu_torch.ops.cuda import tolerance
    b_ms, b_by = bound_ms_by
    abs_errs = [c[0] for c in checks] + ([] if lse_err is None else [lse_err])
    f_rel = min(c[2] for c in checks if c[2] is not None)
    results.append({
        "name": name, "path": path, "route": "cuda",
        "source": f"deepspeed_tpu_torch/csrc/{_source(name)}.cu",
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
          "row_rtol": tolerance.ROW_RTOL[limit or name],
          "fault": fault, "fault_row_rel_err": f_rel,
          "lse_abs_err": lse_err, **(extra or {})})


# ------------------------------------------------------------------ phases

def phase_device():
    """The card, the kernels' build, the host libraries' build (the
    native SIMD Adam and the aio handle, with g++), the host (memory,
    cores, the NVMe directory's filesystem and free space) and the
    pinned copy rates of a 1 GiB tensor each way. Returns (the
    nvidia-smi lines, the rates)."""
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.ops.native import aio, cpu_adam
    from deepspeed_tpu_torch.ops.native import builder as native_builder
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    lib = builder.kernels()
    cpu_adam.load()
    aio.load()
    rates = pinned_rates()
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "kernel_build_s": lib.build_s, "built": lib.built,
            "library": lib.path,
            "native_build_s": dict(native_builder.build_seconds),
            "aio_backend": aio.AsyncIOHandle().backend,
            **host_info(tempfile.gettempdir()),
            "pinned_h2d_gb_s": rates["h2d"], "pinned_d2h_gb_s": rates["d2h"],
            "pinned_duplex_gb_s": rates["duplex"]}
    emit(info)
    return smi, rates


def kernel_phase(eng, cfg, gen):
    """Every kernel at the main path's shapes against its plain version,
    and a planted fault of each against the same check. On the int8
    engine (path serve_gpt2_int8) the int8 branches of ln_qkv_stacked and
    out_ffn_stacked over its codes, and paged attention over its int8
    pool at head dim 64; the flash row is the bf16 engine's."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import tolerance
    p, ad = eng.adapter.p, eng.adapter
    dev = ad.device
    L, E, H, D, Fd = (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_dim,
                      cfg.n_inner)
    B = eng.spec.slots
    lids = ad._layer_ids
    (Wq, sq), (Wp, sp), (W1, s1), (W2, s2) = ad._w
    int8 = Wq.dtype == torch.int8
    if int8 != (len(eng.cache.pool) == 4):
        raise AssertionError("the int8 engine holds int8 weights and pool")
    wb = Wq.element_size()
    path = "serve_gpt2_int8" if int8 else "serve"
    key = ({"ln_qkv": "ln_qkv_stacked[ln,int8]",
            "out_ffn": "out_ffn_stacked[int8]",
            "paged": "decode_attention_paged[int8,d64]"} if int8 else
           {"ln_qkv": "ln_qkv_stacked", "out_ffn": "out_ffn_stacked",
            "paged": "decode_attention_paged"})
    weights = {"weights": "int8"} if int8 else {}
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
    qkv_args = (p["ln1_w"], p["ln1_b"], Wq, sq, p["attn_qkvb"])
    got = dk.ln_qkv_stacked(x, *qkv_args, lids[LAYER], eps=eps)
    # fault: the last 32 weight rows (one row group of K) left out
    f_args = at_layer(*qkv_args)
    f_args[2][:, -32:] = 0
    checks = [held(key["ln_qkv"], got,
                   dk.ln_qkv_stacked_plain(x, *qkv_args, LAYER, eps),
                   dk.ln_qkv_stacked_plain(x, *f_args, 0, eps))]
    ms = time_graph_ms(lambda i: dk.ln_qkv_stacked(x, *qkv_args, lids[i],
                                                   eps=eps))
    call_ms = time_ms(lambda: dk.ln_qkv_stacked(x, *qkv_args,
                                                lids[next(cyc)], eps=eps))
    plain_ms = time_ms(lambda: dk.ln_qkv_stacked_plain(
        x, *qkv_args, next(cyc), eps), reps=20, inner=1)
    N = 3 * E
    record(results, "ln_qkv_stacked", path,
           "deepspeed_tpu/ops/pallas/decode.py:496",
           checks, ms, call_ms, plain_ms,
           bound(nbytes(x) + E * N * wb + 4 + 2 * E * 4 + N * 4 + B * N * 2,
                 2 * B * E * N), [{"B": B, "E": E, "N": N, "L": L,
                                   **weights}],
           "the last 32 of the 1280 weight rows dropped", limit=key["ln_qkv"],
           extra=proj_extra("ln_qkv_stacked",
                            lambda: dk.ln_qkv_stacked(x, *qkv_args,
                                                      lids[LAYER], eps=eps),
                            B, wb, [(E, N, "ln_bf16")]))

    # -- decode_attention_paged: scattered pages, one idle slot; the
    # pool refilled at random (int8: codes and per-row scales)
    pool = eng.cache.pool
    for t in pool:
        for layer in t:
            if t.dtype == torch.int8:
                layer.copy_(torch.randint(-128, 128, layer.shape,
                                          generator=gen, device=dev,
                                          dtype=torch.int8))
            elif int8:
                layer.copy_(torch.rand(layer.shape, generator=gen,
                                       device=dev) * 0.01 + 0.002)
            else:
                layer.copy_(torch.randn(layer.shape, generator=gen,
                                        device=dev, dtype=torch.float32)
                            .to(layer.dtype) * 0.5)
    kc, vc = pool[0], pool[len(pool) // 2]
    sc = {"k_scale": pool[1], "v_scale": pool[3]} if int8 else {}
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
                                        rows_per_step=rps, **sc)
        if torch.count_nonzero(got[B - 1]):
            raise AssertionError("idle slot output is not zero")
        fault = dk.decode_attention_paged_plain(
            q, kc, vc, pos_fault, pt, LAYER, **sc) if R == 1 else None
        checks.append(held(key["paged"], got,
                           dk.decode_attention_paged_plain(
                               q, kc, vc, pos_r, pt, LAYER,
                               rows_per_step=rps, **sc), fault))
        cases.append({"B": B, "H": H, "R": R, "D": D, "page": page,
                      "rows_per_step": rps, "pos": pos_r.tolist(),
                      "pool": "int8" if int8 else "bf16"})
    # the main path's call: the tick's new K/V rows (column slices of the
    # packed qkv output) appended by the attention call itself
    q = rnd(B, H, 1, D)
    qkv = rnd(B, 3 * E)
    k3, v3 = qkv[:, E:2 * E].view(B, H, D), qkv[:, 2 * E:].view(B, H, D)

    def attend(l, fold=True):
        rows = dict(new_k=k3, new_v=v3) if fold else {}
        return dk.decode_attention_paged(q, kc, vc, pos, pt, lids[l], **sc,
                                         **rows)
    slots, blk, row = paged_rows(pos, pt, page)
    check, fold, ms, _ = fold_extra(
        attend, lambda: dk.decode_attention_paged_plain(q, kc, vc, pos, pt,
                                                        LAYER, **sc),
        key["paged"], k3, v3, pool, blk, row, slots, n=L)
    checks.append(check)
    cases.append({"B": B, "H": H, "R": 1, "D": D, "page": page,
                  "pos": pos_list, "new_rows": True})
    call_ms = time_ms(lambda: attend(next(cyc)))

    def plain():
        l = next(cyc)
        dk.paged_append_plain(kc, vc, pos, pt, l, k3, v3, **sc)
        dk.decode_attention_paged_plain(q, kc, vc, pos, pt, l, **sc)
    plain_ms = time_ms(plain, reps=20, inner=1)
    # this run's data: the live K/V rows (codes and a scale each, if
    # int8), q and out, pos, live table rows, and the append's rows
    live = sum(pp + 1 for pp in pos_list if pp >= 0)
    pages_read = sum(pp // page + 1 for pp in pos_list if pp >= 0)
    row_bytes = D * kc.element_size() + (4 if int8 else 0)
    record(results, "decode_attention_paged", path,
           "deepspeed_tpu/ops/pallas/decode.py:931", checks, ms, call_ms,
           plain_ms,
           bound(live * H * row_bytes * 2 + 2 * nbytes(q) + nbytes(pos)
                 + pages_read * 4 + append_bytes(len(slots), H, D, pool),
                 4 * live * H * D), cases,
           "each live slot's last page dropped (R=1)", limit=key["paged"],
           extra={**fold, **attn_plan(key["paged"], lambda: attend(LAYER),
                                      q, maxp * page)})

    # -- out_ffn_stacked: three launches per call
    ctx, x = rnd(B, E), rnd(B, E)
    ffn = (Wp, sp, p["attn_ob"], p["ln2_w"], p["ln2_b"], W1, s1,
           p["inter_b"], W2, s2, p["output_b"])
    got = dk.out_ffn_stacked(ctx, x, *ffn, lids[LAYER], eps=eps)
    # fault: the last 64 rows of Wp (one K tile of launch (a)) left out
    f_ffn = at_layer(*ffn)
    f_ffn[0][:, -64:] = 0
    checks = [held(key["out_ffn"], got,
                   dk.out_ffn_stacked_plain(ctx, x, *ffn, LAYER, eps=eps),
                   dk.out_ffn_stacked_plain(ctx, x, *f_ffn, 0, eps=eps))]
    ms = time_graph_ms(lambda i: dk.out_ffn_stacked(ctx, x, *ffn, lids[i],
                                                    eps=eps))
    call_ms = time_ms(lambda: dk.out_ffn_stacked(ctx, x, *ffn,
                                                 lids[next(cyc)], eps=eps))
    plain_ms = time_ms(lambda: dk.out_ffn_stacked_plain(
        ctx, x, *ffn, next(cyc), eps=eps), reps=20, inner=1)
    w_bytes = (E * E + 2 * E * Fd) * wb + 3 * 4
    v_bytes = (6 * E + Fd) * 4
    record(results, "out_ffn_stacked", path,
           "deepspeed_tpu/ops/pallas/decode.py:1000",
           checks, ms, call_ms, plain_ms,
           bound(w_bytes + v_bytes + 3 * B * E * 2,
                 2 * B * (E * E + 2 * E * Fd)),
           [{"B": B, "E": E, "F": Fd, "launches_per_call": 3, **weights}],
           "the last 64 of the 1280 rows of Wp dropped",
           limit=key["out_ffn"],
           extra=proj_extra("out_ffn_stacked",
                            lambda: dk.out_ffn_stacked(ctx, x, *ffn,
                                                       lids[LAYER], eps=eps),
                            B, wb, gpt2_ffn_launches(E, Fd)))
    if int8:
        torch.cuda.synchronize()
        return results

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
    # the long case is also the row of _flash_fwd_chunked (the TPU's
    # K/V-streamed forward for long S), whose contract this kernel covers:
    # timed beside SDPA and the plain version, with its bound
    S, Hq = 8192, 4
    q, k, v = rnd(1, Hq, S, D), rnd(1, Hq, S, D), rnd(1, Hq, S, D)
    next(c for c in cases if c["S"] == S).update({
        **flash_variants(q, k, v, True, n=8),
        "kernel_us": 1e3 * time_graph_ms(
            lambda i: fa.flash_attention_fwd(q, k, v, causal=True), n=8),
        "library_us": 1e3 * time_graph_ms(
            lambda i: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True), n=8),
        "plain_us": 1e3 * time_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, causal=True), reps=3, inner=1),
        "bound_us": 1e3 * bound(4 * Hq * S * D * 2 + Hq * S * 4,
                                4 * Hq * D * S * (S + 1) // 2)[0]})
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
           library_ms=lib_ms, lse_err=lse_err,
           extra=flash_variants(q, k, v, True, n=36))
    torch.cuda.synchronize()
    return results


def kv_quant_fault(k, v):
    """A planted fault of kv_quant_int8: codes truncated toward zero (a
    float-to-int cast) instead of rounded."""
    from deepspeed_tpu_torch.ops.cuda.decode import RCP_127
    out = []
    for t in (k, v):
        tf = t.float()
        sc = torch.clamp_min(tf.abs().amax(-1, keepdim=True) * RCP_127, 1e-12)
        out += [torch.clamp(torch.trunc(tf / sc), -127, 127).to(torch.int8),
                sc]
    return out


def written(cache, blk, row):
    """What a cache holds at LAYER, block (or slot) ``blk[i]``, row
    ``row[i]``: (k codes, k scale [n, H, 1], v codes, v scale) of an int8
    cache ([Lyr, NB, H, L, D] codes, [Lyr, NB, H, 1, L] scales), (k rows,
    v rows) of a bf16 one."""
    if len(cache) == 4:
        kc, ks, vc, vs = cache
        return [kc[LAYER][blk, :, row], ks[LAYER][blk, :, 0, row][..., None],
                vc[LAYER][blk, :, row], vs[LAYER][blk, :, 0, row][..., None]]
    return [cache[0][LAYER][blk, :, row], cache[1][LAYER][blk, :, row]]


def paged_rows(pos, pt, page):
    """(live slots, their blocks, their rows) of a paged append: block
    pt[b, min(pos // page, maxp - 1)], row pos % page."""
    live = (pos >= 0).nonzero()[:, 0]
    p = pos.long().clamp(min=0)
    blk = pt.gather(1, (p // page).clamp(max=pt.shape[1] - 1)[:, None])[:, 0]
    return live, blk.long()[live], (p % page)[live]


def fold_extra(attend, plain_out, key, k3, v3, cache, blk, row, live,
               n=36):
    """The folded cache append at a decode attention row: ``attend(l,
    fold)`` calls the row's attention at layer ``l`` (an int), with its
    new K/V rows k3, v3 [B, H, D] (column slices of a packed qkv output,
    as the decode paths pass them) when ``fold``. Once at LAYER: the
    output held at ``key``
    against ``plain_out()`` (the plain version over the cache after the
    write), and what landed at (``blk``, ``row``) for the ``live`` slots
    held bit for bit ("kv_append", limit 0) against kv_quant_int8_plain
    of those rows over an int8 cache (the rows themselves over a bf16
    one) beside a planted fault (codes truncated toward zero; bf16: the K
    and V rows swapped); the call launches no kv_quant_int8. Returns (the
    output's check, the extra keys, ms with the fold, ms without) by
    graph replay over ``n`` layers, the faster of two turns each."""
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    n0 = builder.launches["kv_quant_int8"]
    got = attend(LAYER, True)
    torch.cuda.synchronize()
    if builder.launches["kv_quant_int8"] != n0:
        raise AssertionError("the folded append launched kv_quant_int8")
    check = held(key, got, plain_out())
    kl, vl = k3[live], v3[live]
    if len(cache) == 4:
        want = dk.kv_quant_int8_plain(kl, vl)
        faults = [f if f.dtype == torch.int8 else None
                  for f in kv_quant_fault(kl, vl)]
        fault = "codes truncated toward zero instead of rounded"
    else:
        want, faults = (kl, vl), (vl, kl)
        fault = "the K and V rows swapped"
    checks = [held("kv_append", g, w, f)
              for g, w, f in zip(written(cache, blk, row), want, faults)]
    # with and without, twice in turns: the first graph timed after other
    # GPU work can run slow (PERF.md §7), so each side keeps its faster
    times = {True: [], False: []}
    for _ in range(2):
        for fold in (True, False):
            times[fold].append(time_graph_ms(lambda i: attend(i, fold), n=n))
    ms, ms_no = min(times[True]), min(times[False])
    return check, {
        "append": "int8 codes and scales" if len(cache) == 4
        else "bf16 rows", "append_slots": int(live.numel()),
        "append_held": "bit for bit",
        "append_max_abs_err": max(c[0] for c in checks),
        "append_row_rel_err": max(c[1] for c in checks),
        "append_fault": fault,
        "append_fault_row_rel_err": min(c[2] for c in checks
                                        if c[2] is not None),
        "append_kv_quant_int8_launches": 0,
        "no_fold_us": ms_no * 1e3, "fold_cost_us": (ms - ms_no) * 1e3}, \
        ms, ms_no


def append_bytes(n, H, D, cache):
    """The bytes the folded append moves: ``n`` live slots' new bf16 K and
    V rows of H heads read, their codes and scales (or bf16 rows)
    written."""
    out = D * cache[0].element_size() + (4 if len(cache) == 4 else 0)
    return 2 * n * H * (D * 2 + out)


def kv_quant_row(results, path, k3, v3, write, read, timed, replaces,
                 more=()):
    """kv_quant_int8 at the path's shapes: ``write(lid)`` launches it into
    the path's cache at layer ``lid``, ``read()`` returns the four slices
    it wrote at LAYER, which must equal the plain version's codes and
    scales bit for bit, beside the truncating fault; timed over the
    layers, and bounded by the rows it reads and the codes and scales it
    writes (about 5 fp32 operations a value). ``more``: further (k3, v3,
    write, read) cases, held the same way but not timed. ``path`` is the
    decode path whose shapes these are; the row's path is null: every
    decode path appends inside its attention call (``fold_extra``) and
    launches the kernel no time."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    checks, cases = [], []
    for k_, v_, write_, read_ in ((k3, v3, write, read), *more):
        write_(torch.tensor(LAYER, dtype=torch.int32, device=k_.device))
        want = dk.kv_quant_int8_plain(k_, v_)
        fault = kv_quant_fault(k_, v_)
        checks += [held("kv_quant_int8", g, w, f if f.dtype == torch.int8
                        else None) for g, w, f in zip(read_(), want, fault)]
        cases.append(dict(zip("BHD", k_.shape), held="bit for bit"))
    ms, call_ms, plain_ms = timed(write,
                                  lambda l: dk.kv_quant_int8_plain(k3, v3))
    B, H, D = k3.shape
    n = B * H * D
    record(results, "kv_quant_int8", None, replaces, checks, ms, call_ms,
           plain_ms, bound(2 * n * 2 + 2 * n + 2 * B * H * 4, 2 * n * 5,
                           FP32_FLOP_PER_S),
           [dict(c, shapes_of=path) for c in cases],
           "codes truncated toward zero instead of rounded")


def llama_kernel_phase(eng, cfg, gen):
    """The LLaMA-7B path's kernels at its shapes (8 slots, a scattered page
    table, one idle slot), each against its plain version and a planted
    fault; the paged kernel also at LLaMA-3-8B's GQA geometry (8 KV heads,
    R = 4). On the bf16 engine (path serve_llama) the bf16 kernels and the
    flash forward; on the int8 one (serve_llama_int8) their int8 variants
    over the engine's codes and its int8 pool, refilled at random, and
    kv_quant_int8."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import tolerance
    p, ad = eng.adapter.p, eng.adapter
    dev = ad.device
    L, E, H, Hkv, D, Fd = (cfg.n_layers, cfg.hidden_size, cfg.n_heads,
                           cfg.kv_heads, cfg.head_dim,
                           cfg.intermediate_size)
    B = eng.spec.slots
    lids = ad._layer_ids
    (Wq, sq), (Wo, so), (Wg, sg), (Wu, su), (Wd, sd) = (
        ad._w[k] for k in ("qkv_w", "o_w", "gate_w", "up_w", "down_w"))
    int8 = Wq.dtype == torch.int8
    if int8 != (len(eng.cache.pool) == 4):
        raise AssertionError("the int8 engine holds int8 weights and pool")
    wb = Wq.element_size()                  # bytes of a weight
    path = "serve_llama_int8" if int8 else "serve_llama"
    key = ({"ln_qkv": "ln_qkv_stacked[int8]",
            "matvec": "matvec_stacked[int8]",
            "out_ffn": "out_ffn_stacked[swiglu,int8]",
            "paged": "decode_attention_paged[int8]"} if int8 else
           {"ln_qkv": "ln_qkv_stacked[rms]", "matvec": "matvec_stacked",
            "out_ffn": "out_ffn_stacked[swiglu]",
            "paged": "decode_attention_paged[d128]"})
    weights = [{"weights": "int8"}] if int8 else [{}]
    eps = cfg.rms_eps
    cyc = itertools.cycle(range(L))   # stream every layer: L2 stays cold

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
            cfg.dtype)

    def at_layer(*stacks):
        """LAYER's slice of each per-layer stack, as a stack of one."""
        return [t[LAYER:LAYER + 1].clone() for t in stacks]

    def timed(kernel, plain):
        """(graph-replay ms, eager ms, plain ms) of ``kernel(layer id)``
        and ``plain(layer)`` over the model's layers."""
        return (time_graph_ms(lambda i: kernel(lids[i]), n=L),
                time_ms(lambda: kernel(lids[next(cyc)])),
                time_ms(lambda: plain(next(cyc)), reps=10, inner=1))

    def pool(shape):
        """A random K or V pool of ``shape`` (with its scales if int8)."""
        if not int8:
            return (torch.randn(shape, generator=gen, device=dev)
                    .to(cfg.dtype) * 0.5,)
        return (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8),
                torch.rand(shape[:3] + (1, shape[4]), generator=gen,
                           device=dev) * 0.01 + 0.002)

    results = []

    # -- ln_qkv_stacked, RMSNorm: [8, 4096] . [32, 4096, 12288]
    N = Wq.shape[2]
    x = rnd(B, E)
    f_w = at_layer(p["norm1"], Wq, sq)
    f_w[1][:, -32:] = 0                     # the last 32 weight rows
    checks = [held(key["ln_qkv"],
                   dk.ln_qkv_stacked(x, p["norm1"], None, Wq, sq, None,
                                     lids[LAYER], eps=eps, norm="rms"),
                   dk.ln_qkv_stacked_plain(x, p["norm1"], None, Wq, sq, None,
                                           LAYER, eps, "rms"),
                   dk.ln_qkv_stacked_plain(x, f_w[0], None, f_w[1], f_w[2],
                                           None, 0, eps, "rms"))]
    ms, call_ms, plain_ms = timed(
        lambda lid: dk.ln_qkv_stacked(x, p["norm1"], None, Wq, sq, None, lid,
                                      eps=eps, norm="rms"),
        lambda l: dk.ln_qkv_stacked_plain(x, p["norm1"], None, Wq, sq, None,
                                          l, eps, "rms"))
    qkv_extra = proj_extra(
        "ln_qkv_stacked",
        lambda: dk.ln_qkv_stacked(x, p["norm1"], None, Wq, sq, None,
                                  lids[LAYER], eps=eps, norm="rms"),
        B, wb, [(E, N, "rms_bf16")],
        None if int8 else (lambda i: torch.matmul(x, Wq[i])), L)
    record(results, "ln_qkv_stacked", path,
           "deepspeed_tpu/ops/pallas/decode.py:496", checks, ms, call_ms,
           plain_ms, bound(nbytes(x) + E * N * wb + 4 + E * 4 + B * N * 2,
                           2 * B * E * N),
           [{"B": B, "E": E, "N": N, "L": L, "norm": "rms", **weights[0]}],
           f"the last 32 of the {E} weight rows dropped", limit=key["ln_qkv"],
           extra=qkv_extra)
    # -- the same at 16 slots (no served configuration: path null), held
    # against the plain version with the same fault, and timed
    x16 = rnd(16, E)
    checks = [held(key["ln_qkv"],
                   dk.ln_qkv_stacked(x16, p["norm1"], None, Wq, sq, None,
                                     lids[LAYER], eps=eps, norm="rms"),
                   dk.ln_qkv_stacked_plain(x16, p["norm1"], None, Wq, sq,
                                           None, LAYER, eps, "rms"),
                   dk.ln_qkv_stacked_plain(x16, f_w[0], None, f_w[1], f_w[2],
                                           None, 0, eps, "rms"))]
    ms, call_ms, plain_ms = timed(
        lambda lid: dk.ln_qkv_stacked(x16, p["norm1"], None, Wq, sq, None,
                                      lid, eps=eps, norm="rms"),
        lambda l: dk.ln_qkv_stacked_plain(x16, p["norm1"], None, Wq, sq,
                                          None, l, eps, "rms"))
    record(results, "ln_qkv_stacked", None,
           "deepspeed_tpu/ops/pallas/decode.py:496", checks, ms, call_ms,
           plain_ms, bound(nbytes(x16) + E * N * wb + 4 + E * 4
                           + 16 * N * 2, 2 * 16 * E * N),
           [{"B": 16, "E": E, "N": N, "L": L, "norm": "rms", **weights[0]}],
           f"the last 32 of the {E} weight rows dropped", limit=key["ln_qkv"],
           extra=proj_extra(
               "ln_qkv_stacked",
               lambda: dk.ln_qkv_stacked(x16, p["norm1"], None, Wq, sq, None,
                                         lids[LAYER], eps=eps, norm="rms"),
               16, wb, [(E, N, "rms_bf16")]))

    # -- matvec_stacked: the o-projection, [8, 4096] . [32, 4096, 4096]
    ctx = rnd(B, H * D)
    f_o = at_layer(Wo, so)
    f_o[0][:, -32:] = 0
    checks = [held(key["matvec"],
                   dk.matvec_stacked(ctx, Wo, so, lids[LAYER]),
                   dk.matvec_stacked_plain(ctx, Wo, so, LAYER),
                   dk.matvec_stacked_plain(ctx, *f_o, 0))]
    ms, call_ms, plain_ms = timed(
        lambda lid: dk.matvec_stacked(ctx, Wo, so, lid),
        lambda l: dk.matvec_stacked_plain(ctx, Wo, so, l))
    # one PyTorch call computes the bf16 product; none takes int8 codes
    lib_ms = None if int8 else time_graph_ms(
        lambda i: torch.matmul(ctx, Wo[i]), n=L)
    # the CUDA-core kernel on the same inputs, held to the same limit;
    # reruns of the TMA kernel bit for bit
    bit_equal_reruns("matvec_stacked",
                     lambda: dk.matvec_stacked(ctx, Wo, so, lids[LAYER]))
    fma_err = tolerance.check_kernel(
        key["matvec"], dk.matvec_stacked_fma(ctx, Wo, so, lids[LAYER]),
        dk.matvec_stacked_plain(ctx, Wo, so, LAYER))
    mv_extra = {"fma_us": 1e3 * time_graph_ms(
        lambda i: dk.matvec_stacked_fma(ctx, Wo, so, lids[i]), n=L),
        "fma_row_rel_err": fma_err, "reruns_bit_equal": True,
        "plan": dk.matvec_tma_plan(B, H * D, E, wb)._asdict()}
    record(results, "matvec_stacked", path,
           "deepspeed_tpu/ops/pallas/decode.py:558", checks, ms, call_ms,
           plain_ms, bound(nbytes(ctx) + H * D * E * wb + 4 + B * E * 2,
                           2 * B * H * D * E),
           [{"B": B, "K": H * D, "N": E, "L": L, **weights[0]}],
           f"the last 32 of the {H * D} weight rows dropped",
           library_ms=lib_ms, limit=key["matvec"], extra=mv_extra)

    # -- out_ffn_stacked, RMSNorm + SwiGLU, fuse_proj=False: two launches
    x1 = rnd(B, E)
    ffn = (None, None, None, p["norm2"], None, Wg, sg, None, Wd, sd, None)
    kw = dict(act="swiglu", eps=eps, norm="rms", w1b_stack=Wu, s1b=su,
              fuse_proj=False)
    f_n2, f_g, f_sg, f_d, f_sd, f_u, f_su = at_layer(p["norm2"], Wg, sg, Wd,
                                                     sd, Wu, su)
    f_d[:, -32:] = 0                        # the last 32 rows of Wd
    checks = [held(key["out_ffn"],
                   dk.out_ffn_stacked(None, x1, *ffn, lids[LAYER], **kw),
                   dk.out_ffn_stacked_plain(None, x1, *ffn, LAYER, **kw),
                   dk.out_ffn_stacked_plain(
                       None, x1, None, None, None, f_n2, None, f_g, f_sg,
                       None, f_d, f_sd, None, 0,
                       **dict(kw, w1b_stack=f_u, s1b=f_su)))]
    ms, call_ms, plain_ms = timed(
        lambda lid: dk.out_ffn_stacked(None, x1, *ffn, lid, **kw),
        lambda l: dk.out_ffn_stacked_plain(None, x1, *ffn, l, **kw))
    h8 = rnd(B, Fd)
    ffn_extra = proj_extra(
        "out_ffn_stacked",
        lambda: dk.out_ffn_stacked(None, x1, *ffn, lids[LAYER], **kw),
        B, wb, llama_ffn_launches(E, Fd, wb),
        None if int8 else (lambda i: (torch.matmul(x1, Wg[i]),
                                      torch.matmul(x1, Wu[i]),
                                      torch.matmul(h8, Wd[i]))), L)
    record(results, "out_ffn_stacked", path,
           "deepspeed_tpu/ops/pallas/decode.py:1000", checks, ms, call_ms,
           plain_ms, bound(3 * E * Fd * wb + 3 * 4 + E * 4 + 2 * B * E * 2,
                           3 * 2 * B * E * Fd),
           [{"B": B, "E": E, "F": Fd, "act": "swiglu", "norm": "rms",
             "fuse_proj": False, "launches_per_call": 2, **weights[0]}],
           f"the last 32 of the {Fd} rows of Wd dropped",
           limit=key["out_ffn"], extra=ffn_extra)
    # -- the same at 16 slots (path null)
    x16 = rnd(16, E)
    checks = [held(key["out_ffn"],
                   dk.out_ffn_stacked(None, x16, *ffn, lids[LAYER], **kw),
                   dk.out_ffn_stacked_plain(None, x16, *ffn, LAYER, **kw),
                   dk.out_ffn_stacked_plain(
                       None, x16, None, None, None, f_n2, None, f_g, f_sg,
                       None, f_d, f_sd, None, 0,
                       **dict(kw, w1b_stack=f_u, s1b=f_su)))]
    ms, call_ms, plain_ms = timed(
        lambda lid: dk.out_ffn_stacked(None, x16, *ffn, lid, **kw),
        lambda l: dk.out_ffn_stacked_plain(None, x16, *ffn, l, **kw))
    record(results, "out_ffn_stacked", None,
           "deepspeed_tpu/ops/pallas/decode.py:1000", checks, ms, call_ms,
           plain_ms, bound(3 * E * Fd * wb + 3 * 4 + E * 4 + 2 * 16 * E * 2,
                           3 * 2 * 16 * E * Fd),
           [{"B": 16, "E": E, "F": Fd, "act": "swiglu", "norm": "rms",
             "fuse_proj": False, "launches_per_call": 2, **weights[0]}],
           f"the last 32 of the {Fd} rows of Wd dropped",
           limit=key["out_ffn"],
           extra=proj_extra(
               "out_ffn_stacked",
               lambda: dk.out_ffn_stacked(None, x16, *ffn, lids[LAYER], **kw),
               16, wb, llama_ffn_launches(E, Fd, wb)))
    del x16, h8

    # -- decode_attention_paged at head dim 128: the engine's pool (MHA,
    # R = 1), refilled at random one layer at a time, and a
    # LLaMA-3-8B-shaped pool (8 KV heads, R = 4)
    nb, maxp, page = (eng.cache.num_blocks, eng.spec.max_pages_per_slot,
                      eng.spec.page_size)

    def fill(t):
        """Random codes, scales or bf16 values into t."""
        if t.dtype == torch.int8:
            return t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                         device=dev, dtype=torch.int8))
        if int8:                            # an int8 cache's scales
            return t.copy_(torch.rand(t.shape, generator=gen, device=dev)
                           * 0.01 + 0.002)
        return t.copy_(torch.randn(t.shape, generator=gen, device=dev,
                                   dtype=torch.float32).to(t.dtype) * 0.5)

    def with_scales(cache):
        """(k, v, {k_scale, v_scale}) of a pool tuple."""
        if int8:
            return cache[0], cache[2], dict(k_scale=cache[1],
                                            v_scale=cache[3])
        return cache[0], cache[1], {}
    for t in eng.cache.pool:
        for layer in t:
            fill(layer)
    shape = (2, nb, 8, page, D)
    gqa = tuple(fill(torch.empty(s_, dtype=dt, device=dev)) for s_, dt in (
        ((shape, torch.int8), (shape[:3] + (1, page), torch.float32)) * 2
        if int8 else ((shape, cfg.dtype),) * 2))
    pos_list = [511, 300, 17, 700, 100, 1000, 64, -1][:B]
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    pt = perm[:B * maxp].reshape(B, maxp).to(torch.int32).contiguous()
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    pos_fault = torch.where(pos >= page, pos // page * page - 1, pos)
    checks, cases = [], []
    for cache, hk, R, rps in ((eng.cache.pool, Hkv, 1, None),
                              (gqa, 8, 4, None), (gqa, 8, 4, 2)):
        k_, v_, sc = with_scales(cache)
        q = rnd(B, hk, R, D)
        pos_r = pos.clamp(max=maxp * page - R) if rps else pos
        got = dk.decode_attention_paged(q, k_, v_, pos_r, pt, lids[1],
                                        rows_per_step=rps, **sc)
        if torch.count_nonzero(got[B - 1]):
            raise AssertionError("idle slot output is not zero")
        fault = dk.decode_attention_paged_plain(
            q, k_, v_, pos_fault, pt, 1, **sc) if rps is None else None
        checks.append(held(key["paged"], got,
                           dk.decode_attention_paged_plain(
                               q, k_, v_, pos_r, pt, 1, rows_per_step=rps,
                               **sc), fault))
        cases.append({"B": B, "Hkv": hk, "R": R, "D": D, "page": page,
                      "rows_per_step": rps, "pos": pos_r.tolist(),
                      "pool": "int8" if int8 else "bf16"})
    del gqa
    # the main path's call: the tick's new K/V rows (column slices of the
    # packed qkv output, as the adapter passes them after RoPE) appended
    # by the attention call itself
    kc, vc, sc = with_scales(eng.cache.pool)
    q = rnd(B, Hkv, H // Hkv, D)
    qkv = rnd(B, N)
    k3 = qkv[:, H * D:(H + Hkv) * D].view(B, Hkv, D)
    v3 = qkv[:, (H + Hkv) * D:].view(B, Hkv, D)

    def attend(l, fold=True):
        rows = dict(new_k=k3, new_v=v3) if fold else {}
        return dk.decode_attention_paged(q, kc, vc, pos, pt, lids[l], **sc,
                                         **rows)
    slots, blk, row = paged_rows(pos, pt, page)
    check, fold, ms, _ = fold_extra(
        attend, lambda: dk.decode_attention_paged_plain(q, kc, vc, pos, pt,
                                                        LAYER, **sc),
        key["paged"], k3, v3, eng.cache.pool, blk, row, slots, n=L)
    checks.append(check)
    cases.append({"B": B, "Hkv": Hkv, "R": H // Hkv, "D": D, "page": page,
                  "pos": pos_list, "new_rows": True})
    call_ms = time_ms(lambda: attend(next(cyc)))

    def plain():
        l = next(cyc)
        dk.paged_append_plain(kc, vc, pos, pt, l, k3, v3, **sc)
        dk.decode_attention_paged_plain(q, kc, vc, pos, pt, l, **sc)
    plain_ms = time_ms(plain, reps=10, inner=1)
    # this run's data: the live K/V rows (codes and a scale each, if
    # int8), q and out, pos, the live table entries, the append's rows
    live = sum(pp + 1 for pp in pos_list if pp >= 0)
    pages_read = sum(pp // page + 1 for pp in pos_list if pp >= 0)
    row_bytes = D * kc.element_size() + (4 if int8 else 0)
    record(results, "decode_attention_paged", path,
           "deepspeed_tpu/ops/pallas/decode.py:931", checks, ms, call_ms,
           plain_ms,
           bound(live * Hkv * row_bytes * 2 + 2 * nbytes(q) + nbytes(pos)
                 + pages_read * 4
                 + append_bytes(len(slots), Hkv, D, eng.cache.pool),
                 4 * live * H * D), cases,
           "each live slot's last page dropped (R=1 and R=4)",
           limit=key["paged"],
           extra={**fold, **attn_plan(key["paged"], lambda: attend(1), q,
                                      maxp * page)})

    if int8:
        # -- kv_quant_int8 alone (the JAX signature; no decode path
        # launches it): the tick's new K/V rows into the pool at each
        # slot's next row
        blk = pt[:, 3].contiguous()
        rows = (pos.clamp(min=0) % page).to(torch.int32)
        ks, vs = sc["k_scale"], sc["v_scale"]
        kv_quant_row(
            results, path, k3, v3,
            lambda lid: dk.kv_quant_int8(k3, v3, out=eng.cache.pool,
                                         layer=lid, blocks=blk, rows=rows),
            lambda: (kc[LAYER][blk, :, rows],
                     ks[LAYER][blk, :, 0, rows][..., None],
                     vc[LAYER][blk, :, rows],
                     vs[LAYER][blk, :, 0, rows][..., None]),
            timed, "deepspeed_tpu/ops/pallas/decode.py:279")
        torch.cuda.synchronize()
        return results

    # -- flash_attention_fwd at head dim 128: prefill buckets, GQA
    checks, cases, lse_err = [], [], 0.0
    for S, Hq, Hk, causal in ((16, H, H, True), (1024, H, H, True),
                              (1024, H, H // 4, False)):
        q, k, v = rnd(1, Hq, S, D), rnd(1, Hk, S, D), rnd(1, Hk, S, D)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        fault = None if causal else fa.flash_attention_fwd_plain(
            q, k[:, :, :-64], v[:, :, :-64])[0]
        checks.append(held("flash_attention_fwd[d128]", o, o_ref, fault))
        lse_err = max(lse_err, tolerance.check_lse(lse, lse_ref))
        cases.append({"S": S, "H": Hq, "Hkv": Hk, "D": D, "causal": causal})
        del o_ref, lse_ref, fault
    S = 1024
    q, k, v = rnd(1, H, S, D), rnd(1, H, S, D), rnd(1, H, S, D)
    ms = time_graph_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal=True),
                       n=L)
    call_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, causal=True), reps=10, inner=1)
    lib_ms = time_graph_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), n=L)
    record(results, "flash_attention_fwd", path,
           "deepspeed_tpu/ops/pallas/flash_attention.py:122", checks, ms,
           call_ms, plain_ms,
           bound(4 * H * S * D * 2 + H * S * 4,
                 4 * H * D * S * (S + 1) // 2), cases,
           "the last 64-key tile dropped (S=1024, GQA, not causal)",
           library_ms=lib_ms, lse_err=lse_err,
           limit="flash_attention_fwd[d128]",
           extra=flash_variants(q, k, v, True, n=L))
    torch.cuda.synchronize()
    return results


def train_kernel_phase(gen):
    """The flash kernels at the training shape (B=8, H=20, S=1024, D=64,
    causal): the forward, held against its plain version with a planted
    fault and timed beside SDPA; the backward's kernels there, at S=8192
    and not causal, with a planted fault each, timed beside SDPA's
    backward."""
    return flash_rows(gen, TRAIN_BATCH, "train",
                      ((1, 4, 8192, 64, True), (1, 20, 1024, 64, False)))


def flash_rows(gen, batch, path, more_bwd_cases=(), H=20, S=TRAIN_SEQ,
               D=64):
    """The rows of the flash kernels on a training path whose attention
    runs at (``batch``, ``H``, ``S``, ``D``, causal): the forward and the
    backward's kernels held there against their plain versions with a
    planted fault each (the backward also at ``more_bwd_cases``, (B, H,
    S, D, causal)), timed there beside SDPA and its backward."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import tolerance
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    results = []
    B = batch
    q, k, v = (rnd(B, H, S, D) for _ in range(3))
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
    record(results, "flash_attention_fwd", path,
           "deepspeed_tpu/ops/pallas/flash_attention.py:122", checks, ms,
           call_ms, plain_ms,
           bound(4 * B * H * S * D * 2 + B * H * S * 4,
                 4 * B * H * D * S * (S + 1) // 2),
           [{"B": B, "S": S, "H": H, "Hkv": H, "D": D, "causal": True}],
           "every batch element given element 0's K/V", library_ms=lib_ms,
           lse_err=lse_err, extra=flash_variants(q, k, v, True, n=36))
    del q, k, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    return results + flash_bwd_rows(
        gen, path, ((batch, H, S, D, True),) + tuple(more_bwd_cases))


def flash_bwd_rows(gen, path, cases):
    """The flash backward's two kernels, ``flash_attention_bwd`` (dq, dk
    and dv, one pass) and ``flash_attention_bwd_delta``, held against their
    plain versions at each of ``cases`` ((B, H, S, D, causal); the first
    is ``path``'s own shape, where the rows are timed and bounded), each
    beside a planted fault (the last 64-row q tile's contribution dropped
    from dk and dv, the first 128-key tile from dq, one position's delta),
    with three reruns bit for bit; then a flash_backward line: the kernel,
    the delta kernel, the eager delta expression it replaces, the whole
    backward (``flash_attention_bwd``: delta + kernel) against its bound
    and SDPA's backward, eager and by CUDA-graph replay."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def inputs(B, H, S, D, causal):
        q, k, v, do = (rnd(B, H, S, D) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        return q, k, v, o, lse, do

    checks, delta_checks = [], []
    for B, H, S, D, causal in cases:
        q, k, v, o, lse, do = inputs(B, H, S, D, causal)
        delta = fa.flash_attention_bwd_delta(o, do)
        delta_p = fa.flash_attention_bwd_delta_plain(o, do)
        delta_f = delta_p.clone()
        delta_f[..., S // 2] = 0
        delta_checks.append(held("flash_attention_bwd_delta", delta,
                                 delta_p, delta_f))
        args = (q, k, v, do, lse, delta_p, causal)
        got = bit_equal_reruns("flash_attention_bwd",
                               lambda: fa.flash_attention_bwd_kernel(*args))
        want = fa.flash_attention_bwd_kernel_plain(*args)
        qf, dof, kf = q.clone(), do.clone(), k.clone()
        qf[:, :, -64:] = 0
        dof[:, :, -64:] = 0
        kf[:, :, :fa.BWD_KEY_TILE] = 0
        _, fault_dk, fault_dv = fa.flash_attention_bwd_kernel_plain(
            qf, k, v, dof, lse, delta_p, causal)
        fault_dq = fa.flash_attention_bwd_kernel_plain(
            q, kf, v, do, lse, delta_p, causal)[0]
        checks += [held("flash_attention_bwd", g, w, f) for g, w, f in
                   zip(got, want, (fault_dq, fault_dk, fault_dv))]
        del got, want, fault_dq, fault_dk, fault_dv, qf, dof, kf
        torch.cuda.empty_cache()
    info = [{"B": B, "H": H, "S": S, "D": D, "causal": c}
            for B, H, S, D, c in cases]

    B, H, S, D, causal = cases[0]
    q, k, v, o, lse, do = inputs(B, H, S, D, causal)
    delta = fa.flash_attention_bwd_delta_plain(o, do)
    args = (q, k, v, do, lse, delta, causal)
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
    mm_flops = 2 * pairs * D                     # one [S, S] x D product
    in_bytes = nbytes(q, k, v, do, lse, delta)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=causal)
    out = sdpa()
    sdpa_ms = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                  retain_graph=True))
    del out          # its graph, kept alive, breaks the capture below
    sdpa_graph_ms = None
    for attempt in range(2):   # (a first capture can fail on a lazy init)
        try:   # forward + backward captured in a graph, less the forward
            sdpa_graph_ms = time_graph_ms(
                lambda i: torch.autograd.grad(sdpa(), (qg, kg, vg), do),
                n=8) - time_graph_ms(lambda i: sdpa(), n=8)
            break
        except RuntimeError as e:
            print(f"SDPA's backward not captured: {e}", file=sys.stderr)
    rows = []
    ms = time_graph_ms(lambda i: fa.flash_attention_bwd_kernel(*args))
    record(rows, "flash_attention_bwd", path,
           "deepspeed_tpu/ops/pallas/flash_attention.py:192", checks, ms,
           time_ms(lambda: fa.flash_attention_bwd_kernel(*args)),
           time_ms(lambda: fa.flash_attention_bwd_kernel_plain(*args),
                   reps=5, inner=1),
           bound(in_bytes + 3 * nbytes(q), 5 * mm_flops), info,
           "the last 64-row q tile's contribution dropped from dk and dv, "
           "the first 128-key tile from dq", library_ms=sdpa_ms,
           extra={"reruns_bit_equal": True,
                  "sdpa_backward_graph_us":
                      None if sdpa_graph_ms is None else sdpa_graph_ms * 1e3})
    delta_ms = time_graph_ms(lambda i: fa.flash_attention_bwd_delta(o, do))
    expr_ms = time_graph_ms(
        lambda i: fa.flash_attention_bwd_delta_plain(o, do))
    record(rows, "flash_attention_bwd_delta", path,
           "deepspeed_tpu/ops/pallas/flash_attention.py:260", delta_checks,
           delta_ms, time_ms(lambda: fa.flash_attention_bwd_delta(o, do)),
           time_ms(lambda: fa.flash_attention_bwd_delta_plain(o, do)),
           bound(2 * nbytes(o) + nbytes(delta), 2 * o.numel(),
                 FP32_FLOP_PER_S), info, "one position's delta dropped",
           extra={"plain_graph_us": expr_ms * 1e3})
    whole_ms = time_graph_ms(
        lambda i: fa.flash_attention_bwd(q, k, v, o, lse, do, causal))
    b_ms, b_by = bound(in_bytes + 3 * nbytes(q), 5 * mm_flops)
    emit({"phase": "flash_backward", "path": path, "B": B, "H": H, "S": S,
          "D": D, "causal": causal, "kernel_us": ms * 1e3,
          "delta_us": delta_ms * 1e3, "delta_expression_us": expr_ms * 1e3,
          "whole_backward_us": whole_ms * 1e3, "bound_us": b_ms * 1e3,
          "bound_by": b_by, "pct_of_bound": 100.0 * b_ms / whole_ms,
          "sdpa_backward_us": sdpa_ms * 1e3,
          "sdpa_backward_graph_us":
              None if sdpa_graph_ms is None else sdpa_graph_ms * 1e3})
    del qg, kg, vg, q, k, v, o, lse, do, delta
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


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
    TRAIN_LOSSES[:] = losses
    timed = losses[warmup:]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"the loss did not fall: {timed}")
    expect = {name: n_layer * steps for name in FLASH_KERNELS}
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
    attention function (a module's ``attention``: GPT-2's
    ``SelfAttention``, ``LlamaAttention``) swapped for ``attention``
    (None: the model's own, the kernels)."""
    blocks = [m for m in model.modules() if hasattr(type(m), "attention")]
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


def grad_errors(engine, ids, leaf_limits=None):
    """One step of ``engine``'s model on ``ids`` (its bf16 compute copy)
    through the kernels, through their plain versions and through a
    planted fault (the first 64-key tile left out of dq, plain versions):
    the losses and each leaf's row-relative error against the plain
    versions' gradients, the line's numbers (``check_grads`` holds each
    leaf to its limit: ``leaf_limits``' where it names the leaf, else
    GRAD_RTOL)."""
    from deepspeed_tpu_torch.ops.cuda import tolerance
    leaf_limits = leaf_limits or {}
    model, names = engine.module, engine.param_names
    loss_k, grads_k = model_loss_and_grads(model, ids)
    loss_p, grads_p = model_loss_and_grads(model, ids, plain_attention())
    loss_f, grads_f = model_loss_and_grads(model, ids,
                                           plain_attention(True))

    def errs(grads):
        return {name: tolerance.row_rel_err(g, w, floor=1e-3)
                for name, g, w in zip(names, grads, grads_p)}
    err, f_err = errs(grads_k), errs(grads_f)
    lim = {name: leaf_limits.get(name, GRAD_RTOL) for name in names}
    share = {name: e / lim[name] for name, e in err.items()}
    f_share = {name: e / lim[name] for name, e in f_err.items()}
    worst = max(err, key=err.get)
    held = max(share, key=share.get)
    f_worst = max(f_share, key=f_share.get)
    rest = [e for name, e in err.items() if name not in leaf_limits]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    line = {"leaves": len(err), "loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_rel_err": loss_rel, "loss_limit": LOSS_RTOL,
            "max_row_rel_err": err[worst], "worst_leaf": worst,
            "median_row_rel_err": float(np.median(list(err.values()))),
            "limit": GRAD_RTOL, "leaf_limits": dict(leaf_limits),
            "max_row_rel_err_at_limit": max(rest),
            "leaf_rel_err": {name: err[name] for name in leaf_limits},
            "max_share_of_limit": share[held], "nearest_limit_leaf": held,
            "fault": "the first 64-key tile left out of dq (plain versions)",
            "fault_loss": loss_f, "fault_max_row_rel_err": f_err[f_worst],
            "fault_worst_leaf": f_worst,
            "fault_max_share_of_limit": f_share[f_worst],
            "fault_leaf_rel_err": {name: f_err[name] for name in leaf_limits},
            "fault_leaves_rejected": sum(s > 1 for s in f_share.values()),
            "top_leaves": dict(sorted(err.items(),
                                      key=lambda kv: -kv[1])[:6])}
    return line


def check_grads(line):
    """Raise unless ``grad_errors``' line holds: every leaf within its
    limit, the losses within LOSS_RTOL, the planted fault beyond a leaf's
    limit."""
    if not line["max_share_of_limit"] <= 1.0:
        leaf = line["nearest_limit_leaf"]
        raise AssertionError(
            f"grad check: {leaf} row-relative error over its limit "
            f"{line['leaf_limits'].get(leaf, line['limit'])} "
            f"({line['max_share_of_limit']:.3g} of it)")
    if not line["loss_rel_err"] <= LOSS_RTOL:
        raise AssertionError(f"grad check: loss {line['loss_kernels']} vs "
                             f"plain {line['loss_plain']} "
                             f"({line['loss_rel_err']:.3g} > {LOSS_RTOL})")
    if not line["fault_max_share_of_limit"] > 1.0:
        raise AssertionError(f"grad check: a planted fault "
                             f"({line['fault_max_row_rel_err']:.3g}) passes "
                             f"the check")


def grad_check_phase(n_layer=2):
    """A 2-layer model of GPT-2 large's width, as ``initialize`` holds it
    on the card (bf16 compute copy): one step's gradients through the
    kernels against the same step through their plain versions, every
    leaf at GRAD_RTOL and the losses at LOSS_RTOL; then through a planted
    fault (the first 64-key tile left out of dq), which the same limit
    must reject."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import gpt2
    engine, _, _, _ = ds.initialize(
        config=train_ds_config(),
        model=gpt2.GPT2LMHeadModel(train_model_config(n_layer)))
    line = grad_errors(engine, train_batch_ids()["input_ids"])
    emit({"phase": "grad_check", "layers": n_layer, **line})
    check_grads(line)


# ------------------------------------------------------- LLaMA training

def llama_train_config(n_layers=LLAMA_LAYERS):
    """LLaMA-7B's width at ``n_layers`` layers, full-block remat, the loss
    in chunks of LLAMA_LOSS_CHUNK tokens over the untied head."""
    from deepspeed_tpu_torch.models.llama import llama_7b
    return llama_7b(n_layers=n_layers, remat=True,
                    loss_chunk=LLAMA_LOSS_CHUNK)


def llama_ds_config(batch=LLAMA_BATCH):
    """The GPT-2 train config (bf16 compute, fp32 masters, bf16 grads and
    exp_avg, AdamW, clipping 1.0, ZeRO stage 3 on one rank) at ``batch``
    sequences a step."""
    return dict(train_ds_config(), train_batch_size=batch)


def llama_batch_ids(cfg, batch=LLAMA_BATCH, seq=LLAMA_SEQ, seed=0):
    ids = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    return {"input_ids": torch.as_tensor(ids, device="cuda")}


def llama_flops_per_token(cfg, seq):
    """The model FLOPs a token of a training step: 6·N' + 12·L·S·E, N'
    every parameter but the embedding table (a lookup does no products);
    the remat recompute is not counted."""
    n = cfg.num_params() - cfg.vocab_size * cfg.hidden_size
    return 6 * n + 12 * cfg.n_layers * seq * cfg.hidden_size


def train_llama_phase(warmup=TRAIN_WARMUP, steps=TRAIN_STEPS):
    """``initialize`` + ``train_batch`` of LlamaForCausalLM at LLaMA-7B's
    width and LLAMA_LAYERS layers; returns (engine, batch, the run's
    kernel launches). Under full-block remat the flash forward runs twice
    a layer a step (the backward recomputes each block), the backward's
    two kernels once."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.ops.cuda import builder
    cfg = llama_train_config()
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _, _, _ = ds.initialize(config=llama_ds_config(),
                                    model=LlamaForCausalLM(cfg))
    batch = llama_batch_ids(cfg)
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
        raise AssertionError(f"non-finite LLaMA training loss: {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"the LLaMA loss did not fall: {timed}")
    expect = {"flash_attention_fwd": 2 * L * steps,
              "flash_attention_bwd": L * steps,
              "flash_attention_bwd_delta": L * steps}
    if launches != expect:
        raise AssertionError(f"train_llama launch counts {launches} != "
                             f"{expect}")
    step_s = wall_s / steps
    tokens = LLAMA_BATCH * LLAMA_SEQ
    flops = llama_flops_per_token(cfg, LLAMA_SEQ) * tokens
    emit({"phase": "train_llama", "model": "llama_7b", "layers": L,
          "reduced": "depth 32 -> 16", "hidden": cfg.hidden_size,
          "heads": cfg.n_heads, "kv_heads": cfg.kv_heads,
          "head_dim": cfg.head_dim, "ffn": cfg.intermediate_size,
          "vocab": cfg.vocab_size, "params": cfg.num_params(),
          "batch": LLAMA_BATCH, "seq": LLAMA_SEQ, "remat": cfg.remat,
          "loss_chunk": cfg.loss_chunk, "steps": steps,
          "warmup_steps": warmup, "init_and_warmup_s": init_s,
          "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
          "model_tflops_per_step": flops / 1e12,
          "model_tflop_per_s": flops / step_s / 1e12,
          "mfu": flops / step_s / BF16_FLOP_PER_S,
          "step_floor_ms": flops / BF16_FLOP_PER_S * 1e3,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_per_step":
              {k: v / steps for k, v in launches.items()},
          "losses": losses})
    return engine, batch, launches


def llama_init_model(cfg, seed=0):
    """LlamaForCausalLM at ``cfg`` on the card in bf16, as the serving
    phases' LLaMA: seed-``seed`` weights, every matrix and table N(0,
    LLAMA_INIT_STD), the RMSNorm scales 1."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    model = LlamaForCausalLM(cfg, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        for p_ in model.parameters():
            if p_.dim() == 2:                 # reset_parameters' N(0, 0.02)
                p_.mul_(LLAMA_INIT_STD / 0.02)
    return model.to(torch.bfloat16)


def llama_generate_phase(model, state):
    """``llama_generate`` with ``model`` (bf16 weights; ``state`` names
    them: "trained", train_llama's compute copy, or "init",
    ``llama_init_model``'s): B 1, a seeded LLAMA_GEN_PROMPT-token prompt,
    LLAMA_GEN_NEW greedy tokens, timed after a first run that must give
    the same tokens. Each new token is teacher-forced against full
    forwards of the same weights without the cache: within TF_ULPS bf16
    units of the position's top logit of the bf16 forward with plain
    attention (the arithmetic generate runs, so this holds the cache's
    indexing alone), and with the "init" weights also of an fp32 forward
    (the serving phases' oracle: at LLAMA_INIT_STD bf16 rounding stays
    within TF_ULPS of it, where the trained weights amplify it past that);
    a runner-up decoder rejected. The gap against the bf16 forward
    through the flash kernels is printed beside. The path runs no
    hand-written kernel (JAX computes it in plain dot_generals): it
    launches none."""
    from deepspeed_tpu_torch.models.llama import (LlamaForCausalLM,
                                                  llama_generate)
    from deepspeed_tpu_torch.ops.cuda import builder
    cfg = model.config
    prompt = llama_batch_ids(cfg, 1, LLAMA_GEN_PROMPT, seed=1)["input_ids"]
    builder.launches.clear()
    first = llama_generate(model, prompt, LLAMA_GEN_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = llama_generate(model, prompt, LLAMA_GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not torch.equal(first, toks):
        raise AssertionError(f"llama_generate ({state}): two runs differ")
    if dict(builder.launches):
        raise AssertionError(f"llama_generate launched kernels: "
                             f"{dict(builder.launches)}")
    S = LLAMA_GEN_PROMPT
    gen_tok = toks[0, S:].long()
    ctx = toks[:, :-1]

    def forward(dtype, use_flash, weights):
        m = LlamaForCausalLM(dataclasses.replace(
            cfg, dtype=dtype, use_flash=use_flash, remat=False,
            loss_chunk=0))
        with torch.no_grad():
            return torch.func.functional_call(m, weights, (ctx,))[
                0, S - 1:].float()
    named = dict(model.named_parameters())
    gaps, caught = {}, {}
    for key, dtype, use_flash in (("plain_bf16", cfg.dtype, False),
                                  ("flash_bf16", cfg.dtype, None),
                                  ("plain_fp32", torch.float32, False)):
        weights = named if dtype == cfg.dtype else {
            n: p_.detach().float() for n, p_ in named.items()}
        rows = forward(dtype, use_flash, weights)
        del weights
        gap, spacing, ulp = teacher_forced(rows, gen_tok)
        gaps[key] = float((gap / ulp).max())
        caught[key] = int((spacing > TF_ULPS * ulp).sum())
        del rows
    gated = ("plain_bf16",) + (("plain_fp32",) if state == "init" else ())
    emit({"phase": "llama_generate", "model": "llama_7b", "weights": state,
          "init_std": LLAMA_INIT_STD if state == "init" else None,
          "layers": cfg.n_layers, "batch": 1, "prompt": S,
          "new_tokens": LLAMA_GEN_NEW, "generate_s": gen_s,
          "tokens_per_s": LLAMA_GEN_NEW / gen_s,
          "tokens": toks[0, S:].tolist(),
          "teacher_forced_max_gap_ulps": gaps["plain_bf16"],
          "fp32_forward_max_gap_ulps": gaps["plain_fp32"],
          "flash_forward_max_gap_ulps": gaps["flash_bf16"],
          "gated_oracles": list(gated), "limit_ulps": TF_ULPS,
          "runner_up_fault_rejected_at": {k: caught[k] for k in gated},
          "launches": {}})
    for key in gated:
        if gaps[key] > TF_ULPS:
            raise AssertionError(f"llama_generate ({state}): teacher-forced "
                                 f"gap against the {key} forward "
                                 f"{gaps[key]} bf16 units > {TF_ULPS}")
        if caught[key] == 0:
            raise AssertionError(f"llama_generate ({state}): a runner-up "
                                 f"decoder passes the {key} check")
    torch.cuda.empty_cache()


def llama_grad_check_phase():
    """``grad_errors`` at 2 layers of LLaMA-7B's width (MHA, 2 x 2048
    tokens) and of LLaMA-3-8B's (GQA: 8 KV heads, the backward repeating
    K/V and summing dk/dv back; 1 x 2048), each as ``initialize`` holds it
    (bf16 compute copy), with the remat and chunked loss of train_llama."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama3_8b
    cases = []
    for name, cfg, batch in (
            ("llama_7b", llama_train_config(2), 2),
            ("llama3_8b", llama3_8b(n_layers=2, remat=True,
                                    loss_chunk=LLAMA_LOSS_CHUNK), 1)):
        engine, _, _, _ = ds.initialize(config=llama_ds_config(batch),
                                        model=LlamaForCausalLM(cfg))
        ids = llama_batch_ids(cfg, batch)["input_ids"]
        cases.append({"model": name, "layers": cfg.n_layers,
                      "kv_heads": cfg.kv_heads, "batch": batch,
                      "seq": LLAMA_SEQ,
                      **grad_errors(engine, ids, LLAMA_LEAF_RTOL)})
        del engine, ids
        torch.cuda.empty_cache()
    emit({"phase": "llama_grad_check", "cases": cases,
          "gqa_backward": gqa_backward_cost()})
    for line in cases:
        check_grads(line)


def gqa_backward_cost(B=1, H=32, Hkv=8, S=LLAMA_SEQ, D=128):
    """What GQA's repeat-and-sum costs the flash backward at LLaMA-3-8B's
    attention: ``flash_attention_bwd`` with K/V at Hkv heads (repeated to
    H heads, dk/dv summed back over the heads sharing one) against the
    same call on K/V already at H heads (the kernel and its delta alone,
    the products a backward accumulating dk/dv over the shared heads
    would do), each by CUDA-graph replay."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    q, do = rnd(B, H, S, D), rnd(B, H, S, D)
    k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    kf, vf = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    gqa_ms = time_graph_ms(
        lambda i: fa.flash_attention_bwd(q, k, v, o, lse, do, True), n=8)
    mha_ms = time_graph_ms(
        lambda i: fa.flash_attention_bwd(q, kf, vf, o, lse, do, True), n=8)
    return {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
            "gqa_backward_us": gqa_ms * 1e3,
            "kv_at_full_heads_us": mha_ms * 1e3,
            "repeat_and_sum_us": (gqa_ms - mha_ms) * 1e3,
            "repeat_and_sum_share": (gqa_ms - mha_ms) / gqa_ms}


# ------------------------------------------------------- ZeRO-Offload

def host_info(nvme_dir):
    """The host the card sits in: memory (/proc/meminfo), cores, and the
    NVMe tier's directory: its filesystem (/proc/mounts) and free space."""
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                mem[key] = int(value.split()[0]) * 1024 / 1e9
    path = os.path.realpath(nvme_dir)
    fs, mount = None, ""
    with open("/proc/mounts") as f:
        for line in f:
            _, point, kind = line.split()[:3]
            if (path == point or path.startswith(point.rstrip("/") + "/")) \
                    and len(point) > len(mount):
                fs, mount = kind, point
    usage = shutil.disk_usage(nvme_dir)
    return {"mem_total_gb": mem["MemTotal"],
            "mem_available_gb": mem["MemAvailable"],
            "cpu_count": os.cpu_count(), "nvme_dir": nvme_dir,
            "nvme_fs": fs, "nvme_mount": mount,
            "nvme_free_gb": usage.free / 1e9}


def pinned_rates(nbytes=1 << 30, reps=10, warm=3):
    """The best of ``reps`` host-to-card and card-to-host copies of
    ``nbytes``, and of both at once on two streams (their bytes
    together), in GB/s (CUDA events). Each direction has its own pinned
    and device buffers, and every probe runs ``warm`` times untimed
    first."""
    h_in, h_out = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                   for _ in range(2))
    d_in, d_out = (torch.empty(nbytes, dtype=torch.uint8, device="cuda")
                   for _ in range(2))
    streams = [torch.cuda.Stream() for _ in range(2)]

    def duplex():
        cur = torch.cuda.current_stream()
        for st in streams:
            st.wait_stream(cur)
        for st, (dst, src) in zip(streams, ((d_in, h_in), (h_out, d_out))):
            with torch.cuda.stream(st):
                dst.copy_(src, non_blocking=True)
        for st in streams:
            cur.wait_stream(st)
    rates = {}
    for name, fn, moved in (
            ("h2d", lambda: d_in.copy_(h_in, non_blocking=True), nbytes),
            ("d2h", lambda: h_out.copy_(d_out, non_blocking=True), nbytes),
            ("duplex", duplex, 2 * nbytes)):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        rates[name] = moved / best / 1e9
    del h_in, h_out, d_in, d_out
    torch.cuda.empty_cache()
    return rates


def free_host_caches():
    """Return the caching host allocator's pinned blocks to the system
    (earlier phases' staging), before a phase that needs the host's
    memory."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def offload_ds_config(offload, batch=LLAMA_BATCH):
    """train_llama's config with ``offload`` as its offload_optimizer
    block."""
    cfg = llama_ds_config(batch)
    cfg["zero_optimization"] = dict(cfg["zero_optimization"],
                                    offload_optimizer=offload)
    return cfg


def offload_timed_run(engine, batch, warmup, budget_s, max_steps):
    """Warm-up steps, then timed steps while they fit ``budget_s`` (at
    least 2, at most ``max_steps``); the timed run's launches counted
    from 0. Returns (losses, timed steps, wall seconds, launches, the
    per-step device and host times of the two phases)."""
    from deepspeed_tpu_torch.ops.cuda import builder
    t0 = time.perf_counter()
    warm = [engine.train_batch(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / warmup
    steps = max(2, min(max_steps, int(budget_s / step_s)))
    builder.launches.clear()             # count the main path's run only
    marks, timed = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        timed.append(engine.train_batch(batch))
        marks.append(engine.offload_marks)
        if getattr(engine._host_runner, "last_adam_s", None) is not None:
            marks[-1] = marks[-1] + (engine._host_runner.last_adam_s,)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(builder.launches)
    per_step = []
    for m in marks:
        (e0, h0), (e1, h1), (e2, h2) = m[:3]
        per_step.append({"fwd_bwd_ms": e0.elapsed_time(e1),
                         "update_ms": e1.elapsed_time(e2),
                         "fwd_bwd_host_s": h1 - h0,
                         "update_host_s": h2 - h1,
                         **({"cpu_adam_s": m[3]} if len(m) > 3 else {})})
    losses = [float(x) for x in torch.stack(warm + timed).cpu()]
    return losses, steps, wall_s, launches, per_step


def check_losses(name, losses, warmup):
    timed = losses[warmup:]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"{name}: the loss did not fall: {timed}")


def train_llama_offload_phase(rates, stream="auto", warmup=2, budget_s=20.0,
                              max_steps=10):
    """``initialize`` + ``train_batch`` of LlamaForCausalLM at LLaMA-7B's
    width and all LLAMA_OFFLOAD_LAYERS layers with the optimizer state
    off the card: the streamed tier (``stream`` auto: fp32 master, bf16
    exp_avg and fp32 exp_avg_sq in pinned host memory, the update on the
    card) or the host runner (``stream`` host: fp32 master and moments
    in host memory, the native SIMD step on the host's cores). The
    transfer bound is the bytes moved each way (the streamed tier's
    state; the host runner's bf16 gradients and parameters) over the
    one-way pinned rates of ``rates``: the slower direction alone, a
    floor whatever the copies overlap. Both directions' bytes over the
    duplex rate are printed beside it, unchecked (the probe's duplex
    rate is not a ceiling); an update under the bound fails the
    phase."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    host = stream == "host"
    name = "train_llama_offload_host" if host else "train_llama_offload"
    free_host_caches()
    cfg = llama_train_config(LLAMA_OFFLOAD_LAYERS)
    L = cfg.n_layers
    offload = {"device": "cpu", "stream": stream}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _, _, _ = ds.initialize(config=offload_ds_config(offload),
                                    model=LlamaForCausalLM(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    runner = engine._host_runner
    batch = llama_batch_ids(cfg)
    losses, steps, wall_s, launches, per_step = offload_timed_run(
        engine, batch, warmup, budget_s, max_steps)
    check_losses(name, losses, warmup)
    expect = {"flash_attention_fwd": 2 * L * steps,
              "flash_attention_bwd": L * steps,
              "flash_attention_bwd_delta": L * steps}
    if launches != expect:
        raise AssertionError(f"{name} launch counts {launches} != {expect}")
    step_s = wall_s / steps
    tokens = LLAMA_BATCH * LLAMA_SEQ
    flops = llama_flops_per_token(cfg, LLAMA_SEQ) * tokens
    n_params = cfg.num_params()
    line = {"phase": name, "model": "llama_7b", "layers": L,
            "reduced": LLAMA_OFFLOAD_REDUCED, "tier": type(runner).__name__,
            "stream": stream, "params": n_params, "batch": LLAMA_BATCH,
            "seq": LLAMA_SEQ, "remat": cfg.remat,
            "loss_chunk": cfg.loss_chunk, "steps": steps,
            "warmup_steps": warmup, "init_s": init_s,
            "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "model_tflops_per_step": flops / 1e12,
            "mfu": flops / step_s / BF16_FLOP_PER_S,
            "step_floor_ms": flops / BF16_FLOP_PER_S * 1e3,
            "device_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "host_state_gb": runner.host_bytes / 1e9,
            "per_step": per_step,
            "fwd_bwd_ms": statistics.median(s["fwd_bwd_ms"]
                                            for s in per_step),
            "update_ms": statistics.median(s["update_ms"] for s in per_step),
            "launches": launches, "launches_per_step":
                {k: v / steps for k, v in launches.items()},
            "losses": losses}
    if host:
        line["cpu_adam_s"] = statistics.median(s["cpu_adam_s"]
                                               for s in per_step)
        line["cpu_adam_threads"] = runner.native.num_threads()
        # the gradients in (bf16) and the parameters out (bf16)
        moved = 2 * n_params
    else:
        line["pinned_host_gb"] = runner.host_bytes / 1e9
        line["pin_touch_s"] = runner.init_s["touch_s"]
        line["pin_register_s"] = runner.init_s["register_s"]
        line["groups"] = len(runner.groups)
        moved = runner.host_bytes       # each way: master, m, v
    line["bytes_each_way"] = moved
    line["pinned_gb_s"] = dict(rates)
    line["transfer_bound_ms"] = max(moved / rates["h2d"],
                                    moved / rates["d2h"]) / 1e6
    line["transfer_duplex_ms"] = 2 * moved / rates["duplex"] / 1e6
    line["transfer_serial_ms"] = (moved / rates["h2d"]
                                  + moved / rates["d2h"]) / 1e6
    line["transfer_bound_over_update_ms"] = \
        line["transfer_bound_ms"] / line["update_ms"]
    emit(line)
    if not min(s["update_ms"]
               for s in per_step) >= line["transfer_bound_ms"]:
        raise AssertionError(f"{name}: an update beat its transfer bound "
                             f"({line['transfer_bound_ms']:.1f} ms)")
    engine.close()
    del engine, runner, batch
    free_host_caches()
    return launches


def host_step_updates(cfg, batch, steps):
    """The host runner's native step and the device optimizer's FusedAdam
    with fp32 moments, stepped from the same masters with the same
    gradients: ``steps`` steps of the device engine at LLaMA-7B's width,
    each step's gradients (from the engine's compute copy) handed to the
    host runner first and then to the engine's own update. Returns the
    leaf names and the (host, device) updates, after less before."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.config.config import ZeroOffloadConfig
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
    ds_cfg = llama_ds_config(2)
    ds_cfg["optimizer"] = dict(ds_cfg["optimizer"], params=dict(
        ds_cfg["optimizer"]["params"], moment_dtype="fp32"))
    engine, _, _, _ = ds.initialize(config=ds_cfg,
                                    model=LlamaForCausalLM(cfg))
    before = [m.detach().cpu().clone()
              for m in engine.gather_master().values()]
    runner = HostOffloadOptimizer(
        engine.master, engine.optimizer,
        ZeroOffloadConfig({"device": "cpu", "stream": "host"}),
        device="cuda")
    out = [torch.empty_like(p.data) for p in engine.compute_params]
    for _ in range(steps):
        grads, loss = engine._accumulate_grads(batch)
        with torch.no_grad():
            _, coef = engine._clip_coefficient(grads)
            runner.step_streamed(grads, float(engine._lr()),
                                 grad_scale=float(coef), params=out)
        engine._apply_grads(grads, loss)
        engine._refresh_compute_params()
    host = [a - b for a, b in zip(runner.master_leaves(), before)]
    dev = [m.detach().cpu() - b
           for m, b in zip(engine.gather_master().values(), before)]
    names = engine.param_names
    runner.close()
    engine.close()
    del engine, runner, out
    free_host_caches()
    return names, host, dev


def offload_parity_phase(steps=3, fault_leaf="layers.0.attn.q_proj.kernel",
                         coarse=(2.0,), fine=(2.0, 1.01)):
    """LLaMA-7B's width at 2 layers, one seed, ``steps`` steps on three
    engines: the device optimizer, the streamed tier and the host runner.
    Their losses at LOSS_RTOL of the device engine's; each master leaf's
    update (after less before) at OFFLOAD_UPDATE_RTOL: the streamed
    tier's against the device engine's bit for bit, the host runner's
    trajectory (fp32 moments, against the device engine's bf16 exp_avg)
    loosely. Then the host runner's step alone against FusedAdam with
    fp32 moments on the same gradients (``host_step_updates``) at the
    ``host_step`` limit. Planted faults, one leaf's update at ``fine``
    times the lr (``coarse`` for the host runner's trajectory), must
    fail each check."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.ops.cuda import tolerance
    cfg = llama_train_config(2)
    batch = llama_batch_ids(cfg, 2)
    runs = {}
    for tier, offload in (("device", None), ("streamed", {"device": "cpu"}),
                          ("host", {"device": "cpu", "stream": "host"})):
        ds_cfg = llama_ds_config(2) if offload is None \
            else offload_ds_config(offload, 2)
        engine, _, _, _ = ds.initialize(config=ds_cfg,
                                        model=LlamaForCausalLM(cfg))
        names = engine.param_names

        def masters():
            return [m.detach().cpu().clone()
                    for m in engine.gather_master().values()]
        before = masters()
        losses = [float(engine.train_batch(batch)) for _ in range(steps)]
        after = masters()
        runs[tier] = (losses, [a - b for a, b in zip(after, before)])
        engine.close()
        del engine
        free_host_caches()
    ref_losses, ref_upd = runs["device"]
    fault_i = names.index(fault_leaf)

    def check(upd, ref, limit, faults):
        def errs(u):
            return {n: tolerance.row_rel_err(a, r,
                                             tolerance.OFFLOAD_UPDATE_FLOOR)
                    for n, a, r in zip(names, u, ref)}
        e = errs(upd)
        worst = max(e, key=e.get)
        fault_errs = {}
        for f in faults:
            bad = list(upd)
            bad[fault_i] = f * upd[fault_i]
            fault_errs[f"{fault_leaf} at {f} x lr"] = errs(bad)[fault_leaf]
        return {"max_update_row_rel_err": e[worst], "worst_leaf": worst,
                "median_update_row_rel_err": float(np.median(
                    list(e.values()))),
                "faults": fault_errs, "update_limit": limit}
    cases = {}
    for tier in ("streamed", "host"):
        losses, upd = runs[tier]
        cases[tier] = dict(
            check(upd, ref_upd, tolerance.OFFLOAD_UPDATE_RTOL[tier],
                  coarse if tier == "host" else fine),
            losses=losses, loss_rel_err=max(
                abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)))
    step_names, host_upd, dev_upd = host_step_updates(cfg, batch, steps)
    assert step_names == names
    cases["host_step"] = check(host_upd, dev_upd,
                               tolerance.OFFLOAD_UPDATE_RTOL["host_step"],
                               fine)
    emit({"phase": "offload_parity", "model": "llama_7b", "layers": 2,
          "batch": 2, "seq": LLAMA_SEQ, "steps": steps,
          "device_losses": ref_losses, "loss_limit": LOSS_RTOL,
          "update_floor": tolerance.OFFLOAD_UPDATE_FLOOR, "tiers": cases})
    for tier, c in cases.items():
        if "losses" in c and not c["loss_rel_err"] <= LOSS_RTOL:
            raise AssertionError(f"offload_parity: {tier} losses "
                                 f"{c['losses']} vs {ref_losses}")
        if not c["max_update_row_rel_err"] <= c["update_limit"]:
            raise AssertionError(
                f"offload_parity: {tier} update of {c['worst_leaf']} off by "
                f"{c['max_update_row_rel_err']:.3g}")
        for fault, err in c["faults"].items():
            if not err > c["update_limit"]:
                raise AssertionError(f"offload_parity: {tier}: a planted "
                                     f"fault ({fault}: {err:.3g}) passes "
                                     f"the check")


def train_nvme_phase(warmup=1, steps=NVME_STEPS):
    """GPT-2 large (the train phase's model, config, seed and batch) with
    the Adam moments and the parameters on NVMe (ZeRO-Infinity): the
    host runner's SIMD step streams each leaf's moments through the aio
    handles, the parameters are parked between steps and stream back
    before the forward. The directory is a fresh temporary one, removed
    at the end; the disk must hold the moments and the parameters. The
    losses are held at LOSS_RTOL of the train phase's first steps."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    free_host_caches()
    cfg = train_model_config()
    n = cfg.num_params()
    need = n * 8 + n * 2          # fp32 moments, bf16 parameters
    nvme = tempfile.mkdtemp(prefix="dstpu_nvme_")
    try:
        info = host_info(nvme)
        if info["nvme_free_gb"] * 1e9 < 1.2 * need:
            raise AssertionError(
                f"train_nvme: {nvme} has {info['nvme_free_gb']:.1f} GB free, "
                f"the tier needs {need / 1e9:.1f} GB")
        swap = {"device": "nvme", "nvme_path": nvme}
        ds_cfg = dict(train_ds_config(), aio=NVME_AIO)
        ds_cfg["zero_optimization"] = dict(
            ds_cfg["zero_optimization"], offload_optimizer=swap,
            offload_param=dict(swap, pipeline_write=True))
        t0 = time.perf_counter()
        engine, _, _, _ = ds.initialize(config=ds_cfg,
                                        model=GPT2LMHeadModel(cfg))
        init_s = time.perf_counter() - t0
        batch = train_batch_ids()
        reg = engine.metrics
        warm = [engine.train_batch(batch) for _ in range(warmup)]
        torch.cuda.synchronize()
        engine.take_swap_stall_s()
        read0 = reg.counter("swap/bytes_read").value
        written0 = reg.counter("swap/bytes_written").value
        t0 = time.perf_counter()
        timed = [engine.train_batch(batch) for _ in range(steps)]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        stall_s = engine.take_swap_stall_s()
        read = reg.counter("swap/bytes_read").value - read0
        written = reg.counter("swap/bytes_written").value - written0
        handle = engine._host_runner.swapper.handle
        losses = [float(x) for x in torch.stack(warm + timed).cpu()]
        ref = TRAIN_LOSSES[:len(losses)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        step_s = wall_s / steps
        emit({"phase": "train_nvme", "model": "gpt2_large",
              "layers": cfg.n_layer, "params": n,
              "reduced": f"steps {TRAIN_WARMUP} + {TRAIN_STEPS} -> "
                         f"{warmup} + {steps}",
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "aio": NVME_AIO,
              "aio_backend": handle.backend,
              "o_direct": handle.direct_active, **info,
              "moments_gb": n * 8 / 1e9, "params_gb": n * 2 / 1e9,
              "init_s": init_s, "steps": steps, "warmup_steps": warmup,
              "step_ms": step_s * 1e3,
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
              "swap_stall_s_per_step": stall_s / steps,
              "read_gb_per_step": read / steps / 1e9,
              "written_gb_per_step": written / steps / 1e9,
              "read_gb_s": read / wall_s / 1e9,
              "write_gb_s": written / wall_s / 1e9,
              "losses": losses, "train_losses": ref,
              "loss_rel_err": rel, "loss_limit": LOSS_RTOL})
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train_nvme: non-finite loss: {losses}")
        if not rel <= LOSS_RTOL:
            raise AssertionError(f"train_nvme: losses {losses} vs the train "
                                 f"phase's {ref} ({rel:.3g} > {LOSS_RTOL})")
        engine.close()
        del engine
    finally:
        shutil.rmtree(nvme, ignore_errors=True)
    free_host_caches()


# ------------------------------------------------ ZeRO-Infinity, 6.25B GPT-2

def infinity_model_config(n_layer=INF_LAYERS):
    """bench.py's ``bench_infinity_6b`` model (bench.py:1402-1406): GPT-2
    at E 4096 and 32 heads, vocab 50304, bf16 activations and
    parameters, remat, the loss in chunks of 2048."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    return GPT2Config(vocab_size=TRAIN_VOCAB, n_positions=INF_SEQ,
                      n_embd=INF_E, n_layer=n_layer, n_head=INF_HEADS,
                      dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                      scan_layers=True, remat=True, loss_chunk=2048)


def infinity_ds_config(nvme):
    """bench.py's Infinity config (bench.py:1412-1420), O_DIRECT asked
    for."""
    return {"train_batch_size": INF_BATCH,
            "zero_optimization": {
                "stage": 3,
                "offload_param": {"device": "nvme", "nvme_path": nvme,
                                  "stream_segments": INF_SEGMENTS},
                "offload_optimizer": {"device": "cpu"}},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "aio": NVME_AIO}


def infinity_batch():
    ids = np.random.RandomState(0).randint(
        0, TRAIN_VOCAB, size=(INF_BATCH, INF_SEQ)).astype(np.int32)
    return {"input_ids": torch.as_tensor(ids, device="cuda")}


def rss_gb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) * 1024 / 1e9
    return 0.0


def train_infinity_phase(rates, nvme, warmup=1, steps=INF_STEPS):
    """``initialize`` + ``train_batch`` of the InfinityEngine on
    bench_infinity_6b's model and config at full width and depth: the
    tiled init, the state pinned in host memory, the bf16 parameters
    written to ``nvme``, ``warmup`` + ``steps`` steps. The transfer
    bound is the bytes a step moves each way over the one-way pinned
    rates of ``rates`` (the slower direction alone); a step under it
    fails the phase, as a non-finite or not falling loss does. Returns
    (the engine, the batch, the timed run's launches, the losses)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.runtime.zero.infinity import tiled_gpt2_init
    free_host_caches()
    cfg = infinity_model_config()
    n = cfg.num_params()
    info = host_info(nvme)
    if info["nvme_free_gb"] * 1e9 < 1.2 * 2 * n:
        raise AssertionError(f"train_infinity: {nvme} has "
                             f"{info['nvme_free_gb']:.1f} GB free, the "
                             f"parameters take {2 * n / 1e9:.1f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = tiled_gpt2_init(cfg, seed=0)
    tree_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine, _, _, _ = ds.initialize(config=infinity_ds_config(nvme),
                                    model=GPT2LMHeadModel(cfg),
                                    model_parameters=tree)
    init_s = time.perf_counter() - t0
    del tree
    batch = infinity_batch()
    losses = [engine.train_batch(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    builder.launches.clear()             # count the main path's run only
    per_step = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(engine.train_batch(batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m0, m1, m2 = engine.step_marks
        per_step.append({"step_ms": wall * 1e3,
                         "fwd_ms": m0.elapsed_time(m1),
                         "bwd_update_ms": m1.elapsed_time(m2)})
    launches = dict(builder.launches)
    check_losses("train_infinity", losses, warmup)
    L = cfg.n_layer
    expect = {"flash_attention_fwd": 2 * L * steps,
              "flash_attention_bwd": L * steps,
              "flash_attention_bwd_delta": L * steps}
    if launches != expect:
        raise AssertionError(f"train_infinity launch counts {launches} != "
                             f"{expect}")
    moved = engine.transfer_bytes()
    bound_ms = max(moved["h2d"] / rates["h2d"],
                   moved["d2h"] / rates["d2h"]) / 1e6
    step_ms = statistics.median(s["step_ms"] for s in per_step)
    tokens = INF_BATCH * INF_SEQ
    flops = (6 * n + 12 * L * INF_SEQ * cfg.n_embd) * tokens
    emit({"phase": "train_infinity", "model": "gpt2_6.25b",
          "source": "bench.py:1402 bench_infinity_6b", "reduced": "none",
          "params": n, "n_embd": cfg.n_embd, "layers": L,
          "heads": cfg.n_head, "segments": engine.K, "batch": INF_BATCH,
          "seq": INF_SEQ, "param_dtype": "bf16", "moment_dtype": "bf16",
          **info, "o_direct": engine._swapper.handle.direct_active,
          "pinned_gb": engine.host_bytes / 1e9,
          "params_on_disk_gb": engine.params_on_disk_bytes() / 1e9,
          "init_tree_s": tree_s, "init_s": init_s, **engine.init_s,
          "device_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "steps": steps, "warmup_steps": warmup, "per_step": per_step,
          "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
          "fwd_ms": statistics.median(s["fwd_ms"] for s in per_step),
          "bwd_update_ms": statistics.median(s["bwd_update_ms"]
                                             for s in per_step),
          "model_tflops_per_step": flops / 1e12,
          "mfu": flops / (step_ms / 1e3) / BF16_FLOP_PER_S,
          "h2d_gb_per_step": moved["h2d"] / 1e9,
          "d2h_gb_per_step": moved["d2h"] / 1e9,
          "pinned_gb_s": dict(rates), "transfer_bound_ms": bound_ms,
          "transfer_duplex_ms": (moved["h2d"] + moved["d2h"])
          / rates["duplex"] / 1e6,
          "step_over_bound": step_ms / bound_ms,
          "launches": launches, "launches_per_step":
              {k: v / steps for k, v in launches.items()},
          "losses": losses})
    if not min(s["step_ms"] for s in per_step) >= bound_ms:
        raise AssertionError(f"train_infinity: a step beat its transfer "
                             f"bound ({bound_ms:.1f} ms)")
    return engine, batch, launches, losses


def infinity_restore_phase(engine, batch, losses, nvme):
    """``park_to_nvme`` of the trained engine, then a fresh engine built
    with ``restore_params=True`` from the durable files (the moments
    restart at zero): its next loss must be below the run's first."""
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.zero.infinity import InfinityEngine
    cfg = engine.cfg
    t0 = time.perf_counter()
    engine.park_to_nvme()
    park_s = time.perf_counter() - t0
    disk = engine.params_on_disk_bytes()
    engine.close()
    del engine
    free_host_caches()
    aio = DeepSpeedConfig({"train_batch_size": INF_BATCH,
                           "aio": NVME_AIO}).aio_config
    t0 = time.perf_counter()
    fresh = InfinityEngine(cfg, None, segments=INF_SEGMENTS, nvme_path=nvme,
                           lr=1e-4, restore_params=True, aio_config=aio)
    build_s = time.perf_counter() - t0
    loss = fresh.train_batch(batch)
    emit({"phase": "infinity_restore", "model": "gpt2_6.25b",
          "params_on_disk_gb": disk / 1e9, "park_s": park_s,
          "write_gb_s": disk / park_s / 1e9, "build_s": build_s,
          **fresh.init_s,
          "read_gb_s": disk / fresh.init_s["restore_s"] / 1e9,
          "o_direct": fresh._swapper.handle.direct_active,
          "first_loss": losses[0], "last_loss": losses[-1],
          "restored_next_loss": loss})
    if not (math.isfinite(loss) and loss < losses[0]):
        raise AssertionError(f"infinity_restore: the restored engine's loss "
                             f"{loss} is not below the first {losses[0]}")
    fresh.release()
    fresh.close()
    del fresh
    free_host_caches()


def infinity_parity_phase(steps=3, fault_leaf="h.0.attn.c_attn.kernel",
                          faults=(2.0, 1.01)):
    """The Infinity engine at 2 layers of the 6.25B model's width, fp32
    moments, ``steps`` steps on the tiled weights and one batch. K = 1
    against K = 2: losses bit for bit, each master leaf's update (after
    less before) at ``INFINITY_UPDATE_RTOL["segments"]`` (0). Against the
    main engine's device FusedAdam (fp32 moments, no clipping, bf16
    compute copy): each leaf's first update, from the same weights, at
    ``INFINITY_UPDATE_RTOL`` and the losses at LOSS_RTOL; the leaves'
    errors after ``steps`` steps are printed (their trajectories part
    from step 2: wte's gradient sums in fp32 in one, bf16 in the other).
    One leaf's update at each of ``faults`` times the lr must fail both
    checks."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.cuda import tolerance
    from deepspeed_tpu_torch.runtime.zero.infinity import (InfinityEngine,
                                                           tiled_gpt2_init)
    cfg = infinity_model_config(2)
    tree = tiled_gpt2_init(cfg, seed=0)
    batch = infinity_batch()
    bridge = GPT2LMHeadModel(cfg)
    before = {k: v.float() for k, v in bridge.from_jax_tree(tree).items()}

    def run(step, masters):
        losses, upd = [], {}
        for i in range(steps):
            losses.append(step())
            if i in (0, steps - 1):
                upd[i + 1] = {n: m - before[n] for n, m in masters().items()}
        return losses, upd
    runs = {}
    for k in (1, 2):
        eng = InfinityEngine(cfg, tree, segments=k, lr=1e-4,
                             moment_dtype="fp32")
        runs[k] = run(lambda: eng.train_batch(batch),
                      lambda: bridge.from_jax_tree(eng.params_tree()))
        eng.close()
        del eng
    main_cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    engine, _, _, _ = ds.initialize(
        config={"train_batch_size": INF_BATCH, "bf16": {"enabled": True},
                "data_types": {"grad_dtype": "bf16"},
                "optimizer": {"type": "AdamW", "params": {
                    "lr": 1e-4, "moment_dtype": "fp32"}},
                "steps_per_print": 1000},
        model=GPT2LMHeadModel(main_cfg),
        model_parameters={n: v for n, v in before.items()})
    runs["main"] = run(lambda: float(engine.train_batch(batch)),
                       engine.gather_master)
    engine.close()
    del engine
    torch.cuda.empty_cache()
    names = list(before)

    def errors(upd, ref):
        return {n: tolerance.row_rel_err(upd[n], ref[n],
                                         tolerance.OFFLOAD_UPDATE_FLOOR)
                for n in names}

    def check(upd, ref, limit_of):
        errs = errors(upd, ref)
        bad = {n: e for n, e in errs.items() if not e <= limit_of(n)}
        fault_errs = {}
        for f in faults:
            e = tolerance.row_rel_err(f * upd[fault_leaf], ref[fault_leaf],
                                      tolerance.OFFLOAD_UPDATE_FLOOR)
            fault_errs[f"{fault_leaf} at {f} x lr"] = e
            if not e > limit_of(fault_leaf):
                raise AssertionError(f"infinity_parity: a planted fault "
                                     f"({f} x lr: {e:.3g}) passes")
        worst = max(errs, key=errs.get)
        return {"max_update_row_rel_err": errs[worst], "worst_leaf": worst,
                "median_update_row_rel_err": float(np.median(
                    list(errs.values()))),
                "errors": errs, "faults": fault_errs, "over_limit": bad}
    lim = tolerance.INFINITY_UPDATE_RTOL
    k_check = check(runs[2][1][steps], runs[1][1][steps],
                    lambda n: lim["segments"])
    m_check = check(runs[2][1][1], runs["main"][1][1],
                    lambda n: lim.get(n, lim["default"]))
    trajectory = errors(runs[2][1][steps], runs["main"][1][steps])
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(runs[2][0], runs["main"][0]))
    emit({"phase": "infinity_parity", "model": "gpt2_6.25b", "layers": 2,
          "batch": INF_BATCH, "seq": INF_SEQ, "steps": steps,
          "losses_k1": runs[1][0], "losses_k2": runs[2][0],
          "losses_main": runs["main"][0], "loss_rel_err": loss_err,
          "loss_limit": LOSS_RTOL, "limits": lim,
          "update_floor": tolerance.OFFLOAD_UPDATE_FLOOR,
          "k1_vs_k2": k_check, "first_update_vs_main": m_check,
          "after_steps_vs_main": trajectory})
    if runs[1][0] != runs[2][0] or k_check["over_limit"]:
        raise AssertionError(f"infinity_parity: K = 1 and K = 2 differ: "
                             f"{k_check['over_limit']}")
    if m_check["over_limit"] or not loss_err <= LOSS_RTOL:
        raise AssertionError(f"infinity_parity: off the main engine: "
                             f"{m_check['over_limit']}, losses {loss_err}")
    free_host_caches()


def nvme_xl_phase(nvme):
    """bench.py's ``nvme_xl`` scale leg (bench.py:1905-2050): a 10.64B
    bf16 leaf set (GPT-2 shapes at E 5120 and 33 layers, the embedding
    tiled by rows: 142 leaves) parked through a generator under
    O_DIRECT, one pattern buffer in hand, then streamed back twice
    through ``swap_in_stream`` with each leaf's stamp and a sampled
    window checked. Host RSS growth must stay under 1 GiB."""
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig
    from deepspeed_tpu_torch.ops.native import aio as aio_lib
    from deepspeed_tpu_torch.runtime.swap_tensor.swapper import \
        PartitionedParamSwapper
    E, L = XL_E, XL_LAYERS
    shapes = []
    for _ in range(L):
        shapes += [(E, 3 * E), (E, E), (E, 4 * E), (4 * E, E)]
    rows = TRAIN_VOCAB
    while rows > 0:
        shapes.append((min(rows, E), E))
        rows -= min(rows, E)
    total = sum(math.prod(s) for s in shapes)
    total_bytes = 2 * total
    if shutil.disk_usage(nvme).free < 1.15 * total_bytes:
        raise AssertionError(f"nvme_xl: {nvme} has "
                             f"{shutil.disk_usage(nvme).free / 1e9:.1f} GB "
                             f"free, the leaves take {total_bytes / 1e9:.1f}")
    most = max(math.prod(s) for s in shapes) * 2
    pat = aio_lib.aligned_empty(most)
    noise = torch.frombuffer(bytearray(np.random.RandomState(7).bytes(
        1 << 20)), dtype=torch.uint8)
    for a in range(0, most, 1 << 20):
        pat[a:a + (1 << 20)] = noise[:most - a]
    off = 1 << 16
    window = pat[off:off + 4096].clone()

    def gen():
        for i, s in enumerate(shapes):
            nb = math.prod(s) * 2
            pat[:8] = torch.frombuffer(bytearray(int(i).to_bytes(
                8, "little")), dtype=torch.uint8)
            yield pat[:nb].view(torch.bfloat16).view(s)

    aio = DeepSpeedConfig({"train_batch_size": 1,
                           "aio": NVME_AIO}).aio_config
    sw = PartitionedParamSwapper(nvme, aio, pipeline_read=True,
                                 buffer_count=4)
    rss0 = rss_gb()
    rss_max = [rss0]
    t0 = time.perf_counter()
    sw.write_all(gen())
    write_s = time.perf_counter() - t0
    disk = sum(os.path.getsize(sw._path(i)) for i in range(len(shapes)))

    def stream_pass():
        t0 = time.perf_counter()
        ok = 0
        for i, view in sw.swap_in_stream():
            raw = view.view(torch.uint8).reshape(-1)
            stamp = int.from_bytes(bytes(raw[:8].tolist()), "little")
            ok += int(stamp == i and torch.equal(raw[off:off + 4096],
                                                 window))
            rss_max[0] = max(rss_max[0], rss_gb())
        return time.perf_counter() - t0, ok

    pass1_s, ok1 = stream_pass()
    pass2_s, ok2 = stream_pass()
    growth = rss_max[0] - rss0
    line = {"phase": "nvme_xl", "source": "bench.py:1905 bench_nvme_xl",
            "params_b": total / 1e9, "leaves": len(shapes), "layers": L,
            "n_embd": E, "dtype": "bf16", "disk_gb": disk / 1e9,
            "o_direct": sw.handle.direct_active,
            "aio_backend": sw.handle.backend, "write_s": write_s,
            "write_gb_s": disk / write_s / 1e9, "pass1_s": pass1_s,
            "pass2_s": pass2_s, "read_gb_s": [disk / pass1_s / 1e9,
                                              disk / pass2_s / 1e9],
            "verified": [ok1, ok2], "staging_slots": len(sw._staging),
            "rss_before_gb": rss0, "rss_growth_gb": growth,
            "rss_growth_limit_gb": 2 ** 30 / 1e9}
    sw.release()
    emit(line)
    if ok1 != len(shapes) or ok2 != len(shapes):
        raise AssertionError(f"nvme_xl: {ok1}, {ok2} of {len(shapes)} "
                             f"leaves came back whole")
    if not growth < 2 ** 30 / 1e9:
        raise AssertionError(f"nvme_xl: host RSS grew {growth:.2f} GB")


def param_offload_phase(nvme, steps=3, nvme_steps=2):
    """GPT-2 large (the train phase's model, config, seed and batch) with
    ``offload_param: {device: cpu}`` and the device optimizer, 1 +
    ``steps`` steps: the fp32 masters rest in the pinned arena between
    steps and the card frees them. The park is a copy, so losses and
    masters equal the plain engine's bit for bit. Then ``nvme_steps``
    steps of ``offload_param: {device: nvme}`` without offload_optimizer
    (the masters in swap files), losses equal to the train phase's; the
    GB read and written are the steps' after the first (the first reads
    nothing)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    free_host_caches()
    cfg = train_model_config()
    batch = train_batch_ids()
    n = steps + 1

    def run(param, count):
        ds_cfg = train_ds_config()
        if param is not None:
            ds_cfg["zero_optimization"] = dict(ds_cfg["zero_optimization"],
                                               offload_param=param)
            ds_cfg["aio"] = NVME_AIO
        engine, _, _, _ = ds.initialize(config=ds_cfg,
                                        model=GPT2LMHeadModel(cfg))
        losses, allocated = [], []
        for _ in range(count):
            losses.append(float(engine.train_batch(batch)))
            torch.cuda.synchronize()
            allocated.append(torch.cuda.memory_allocated() / 1e9)
        return engine, losses, allocated

    engine, plain_losses, plain_alloc = run(None, n)
    plain = engine.gather_master()
    engine.close()
    del engine
    torch.cuda.empty_cache()
    engine, losses, alloc = run({"device": "cpu"}, n)
    park_ms, unpark_ms = engine._param_host.last_ms()
    pinned = engine._param_host.nbytes
    parked = engine._params_parked
    masters = engine.gather_master()
    equal = all(torch.equal(masters[k], plain[k]) for k in plain)
    engine.close()
    del engine, masters, plain
    torch.cuda.empty_cache()
    engine, nv_losses, nv_alloc = run({"device": "nvme", "nvme_path": nvme},
                                      1)
    reg = engine.metrics
    read0 = reg.counter("swap/bytes_read").value
    written0 = reg.counter("swap/bytes_written").value
    for _ in range(nvme_steps - 1):      # each unparks, then parks
        nv_losses.append(float(engine.train_batch(batch)))
    read = reg.counter("swap/bytes_read").value - read0
    written = reg.counter("swap/bytes_written").value - written0
    direct = engine._param_swapper.handle.direct_active
    engine.close()
    del engine
    free_host_caches()
    ref = TRAIN_LOSSES[:n]
    emit({"phase": "param_offload", "model": "gpt2_large",
          "layers": cfg.n_layer, "params": cfg.num_params(),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps,
          "warmup_steps": 1, "pinned_gb": pinned / 1e9,
          "park_ms": park_ms, "unpark_ms": unpark_ms,
          "allocated_gb_between_steps": alloc,
          "plain_allocated_gb_between_steps": plain_alloc,
          "losses": losses, "plain_losses": plain_losses,
          "train_losses": ref, "masters_bit_equal": equal,
          "nvme_losses": nv_losses, "nvme_o_direct": direct,
          "nvme_allocated_gb_between_steps": nv_alloc,
          "nvme_read_gb_per_step": read / (nvme_steps - 1) / 1e9,
          "nvme_written_gb_per_step": written / (nvme_steps - 1) / 1e9})
    if not (parked and equal and losses == plain_losses
            and losses == ref):
        raise AssertionError(f"param_offload: the pinned tier's run is not "
                             f"the plain one's ({losses} vs "
                             f"{plain_losses}, {ref}; masters equal "
                             f"{equal})")
    if nv_losses != ref[:nvme_steps]:
        raise AssertionError(f"param_offload: the NVMe tier's losses "
                             f"{nv_losses} vs the train phase's {ref}")


def infinity_phases(rates):
    """train_infinity, infinity_restore, infinity_parity, nvme_xl and
    param_offload (after the train phase, whose losses it is held to),
    each with a fresh temporary directory on the host's disk, removed
    after; returns train_infinity's launches."""
    base = tempfile.mkdtemp(prefix="dstpu_infinity_")
    try:
        def fresh(name):
            path = os.path.join(base, name)
            os.makedirs(path)
            return path
        nvme = fresh("infinity")
        engine, batch, launches, losses = train_infinity_phase(rates, nvme)
        infinity_restore_phase(engine, batch, losses, nvme)
        del engine
        infinity_parity_phase()
        nvme_xl_phase(fresh("xl"))
        param_offload_phase(fresh("param"))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return launches


def train_profile_phase(engine, batch, steps=3, phase="train_profile"):
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
    emit({"phase": phase, "steps": steps, "wall_s": wall_s,
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


# ------------------------------------------------------ BERT, block-sparse

def bert_ds_config(batch=BERT_BATCH):
    """bench.py's bench_bert config (bf16, Adam lr 1e-4) with DeepSpeed's
    documented sparse_attention block."""
    return {"train_batch_size": batch, "bf16": {"enabled": True},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
            "sparse_attention": dict(BERT_SPARSE), "steps_per_print": 1000}


def bert_model_config(n_layer=24, positions=BERT_SEQ):
    """BERT-large (bf16 compute) whose layout comes from the config's
    sparse_attention block, as a user builds it: config_to_sparsity, then
    sparse_config_for."""
    from deepspeed_tpu_torch.config.config import SparseAttentionConfig
    from deepspeed_tpu_torch.models.bert import bert_large
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils \
        import SparseAttentionUtils
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
        config_to_sparsity
    cfg = bert_large(dtype=torch.bfloat16, num_hidden_layers=n_layer,
                     max_position_embeddings=positions)
    layout = config_to_sparsity(SparseAttentionConfig(bert_ds_config()),
                                cfg.num_attention_heads)
    return SparseAttentionUtils.sparse_config_for(cfg, layout)


def bert_weights(cfg, seed=0):
    """Seeded weights of a 512-position model on the card, its position
    table extended to cfg's by extend_position_embedding (the reference's
    long-sequence recipe): a state dict for ``initialize``."""
    from deepspeed_tpu_torch.models.bert import BertForPreTraining
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils \
        import SparseAttentionUtils
    small = BertForPreTraining(dataclasses.replace(
        cfg, max_position_embeddings=BERT_POSITIONS), device="cuda")
    small.reset_parameters(torch.Generator(device="cuda").manual_seed(seed))
    return SparseAttentionUtils.extend_position_embedding(
        small.state_dict(), cfg.max_position_embeddings)


def bert_batch(cfg, batch=BERT_BATCH, seq=BERT_SEQ):
    """bench_bert's batch at ``seq``: seeded ids, 15 % MLM labels, NSP
    labels, zero token types and no attention_mask (so the kernels run),
    on the card."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    mlm = np.where(rs.rand(batch, seq) < 0.15, ids, -100).astype(np.int32)
    nsp = rs.randint(0, 2, size=(batch,)).astype(np.int32)
    return {k: torch.as_tensor(v, device="cuda") for k, v in (
        ("input_ids", ids), ("token_type_ids", np.zeros_like(ids)),
        ("mlm_labels", mlm), ("nsp_labels", nsp))}


def bert_loss(model, batch):
    from deepspeed_tpu_torch.models.bert import pretraining_loss
    return pretraining_loss(
        model(batch["input_ids"], None, batch["token_type_ids"]), batch)


def drop_last(tables, line=None, transposed=False):
    """``tables`` with the last listed block left out: of row (column, when
    ``transposed``) ``line`` of table 0, or with ``line`` None of every
    row (column) that lists more than one: a planted fault."""
    field = "counts_t" if transposed else "counts"
    counts = getattr(tables, field).clone()
    if line is None:
        counts -= (counts > 1).to(counts.dtype)
    else:
        counts[0, line] -= 1
    return dataclasses.replace(tables, **{field: counts})


def _fewest(counts):
    """The row of a [TH, nb] count table's table 0 with the fewest (> 1)
    listed blocks: where one block left out shows most."""
    c = counts[0].clone()
    c[c < 2] = c.max() + 1
    return int(c.argmin())


def bert_kernel_phase(gen):
    """The three block-sparse kernels at the main path's shape (B 4, H 16,
    S 4096, D 64, block 16, the per-head Fixed layout: 16 tables), a
    shared BigBird layout at block 64 (one collapsed table) and a layout
    with empty rows, each held against its plain version; planted faults
    at the main shape (a k-block left out of one row's table for the
    forward and dq, a q-block out of one column's for dk/dv); timed there
    beside the plain versions, SDPA over the layout expanded to a boolean
    mask and the port's dense non-causal flash forward + backward."""
    from deepspeed_tpu_torch.ops.cuda import blocksparse as bs
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import tolerance
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import _expand_layout_mask
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
        BigBirdSparsityConfig
    cfg = bert_model_config()
    B, H, S, D, block = BERT_BATCH, cfg.num_attention_heads, BERT_SEQ, 64, \
        cfg.sparsity_config.block
    main = cfg.sparsity_config.make_layout(S)
    np.random.seed(0)
    bigbird = BigBirdSparsityConfig(
        num_heads=H, block=64, num_random_blocks=1,
        num_sliding_window_blocks=3, num_global_blocks=1).make_layout(S)
    empty = main[:2, :64, :64].copy()
    empty[:, 5] = 0                                   # row 5 attends nothing
    cases = (("main", main, block, B, H, S), ("bigbird_b64", bigbird, 64, 1,
                                              H, S),
             ("empty_row", empty, block, 1, 2, 1024))

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    checks = {name: [] for name in BLOCKSPARSE_KERNELS}
    lse_err, info = 0.0, []
    for label, layout, blk, b, h, s in cases:
        tables = bs.layout_tables(layout, s, blk, h, "cuda")
        q, k, v, do = (rnd(b * h, s, D) for _ in range(4))
        o, lse = bs.blocksparse_fwd(q, k, v, tables)
        o_p, lse_p = bs.blocksparse_fwd_plain(q, k, v, tables)
        delta = (do.float() * o_p).sum(-1)
        args = (q, k, v, do, lse_p, delta)
        dq = bs.blocksparse_bwd_dq(*args, tables)
        dk, dv = bs.blocksparse_bwd_dkv(*args, tables)
        dq_p = bs.blocksparse_bwd_dq_plain(*args, tables)
        dk_p, dv_p = bs.blocksparse_bwd_dkv_plain(*args, tables)
        f_o = f_dq = f_dk = f_dv = None
        if label == "main":
            row, col = _fewest(tables.counts), _fewest(tables.counts_t)
            f_o = bs.blocksparse_fwd_plain(q, k, v,
                                           drop_last(tables, row))[0]
            f_dq = bs.blocksparse_bwd_dq_plain(*args, drop_last(tables, row))
            f_dk, f_dv = bs.blocksparse_bwd_dkv_plain(
                *args, drop_last(tables, col, transposed=True))
        checks["blocksparse_fwd"].append(held("blocksparse_fwd", o, o_p, f_o))
        lse_err = max(lse_err, tolerance.check_lse(lse, lse_p,
                                                   "blocksparse_fwd"))
        checks["blocksparse_bwd_dq"].append(
            held("blocksparse_bwd_dq", dq, dq_p, f_dq))
        checks["blocksparse_bwd_dkv"] += [
            held("blocksparse_bwd_dkv", dk, dk_p, f_dk),
            held("blocksparse_bwd_dkv", dv, dv_p, f_dv)]
        nb = s // blk
        info.append({"case": label, "B": b, "H": h, "S": s, "D": D,
                     "block": blk, "table_heads": tables.heads,
                     "density": float(np.asarray(layout)[:, :nb, :nb].mean()),
                     "max_blocks_a_row": int(tables.counts.max()),
                     "max_blocks_a_column": int(tables.counts_t.max()),
                     "empty_rows": int((tables.counts == 0).sum())})
        del o, lse, o_p, lse_p, dq, dk, dv, dq_p, dk_p, dv_p, f_o, f_dq, \
            f_dk, f_dv, q, k, v, do, delta, args
        torch.cuda.empty_cache()

    # timing at the main path's shape
    tables = bs.layout_tables(main, S, block, H, "cuda")
    q, k, v, do = (rnd(B * H, S, D) for _ in range(4))
    o, lse = bs.blocksparse_fwd(q, k, v, tables)
    delta = (do.float() * o).sum(-1)
    args = (q, k, v, do, lse, delta, tables)
    active = B * int(np.asarray(main).sum())          # (b, h, row, col) blocks
    # flops a listed block pair: 2 block^2 D a product; the forward's 2
    # (S, P V), dq's 3 (S, dP, dQ), dk/dv's 4 (S^T, dP^T, dV, dK)
    pair = block * block * D
    io = nbytes(q, k, v)
    rows = []
    mask = _expand_layout_mask(main, block, S, "cuda")[None]
    q4, k4, v4, do4 = (t.view(B, H, S, D) for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd_ms = time_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask), reps=5,
                          inner=2)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    out = sdpa(qg, kg, vg, attn_mask=mask)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do4, retain_graph=True), reps=5, inner=2)
    del out, qg, kg, vg
    for name, fn, plain, flops, nbytes_, replaces, fault, lib in (
            ("blocksparse_fwd", lambda: bs.blocksparse_fwd(q, k, v, tables),
             lambda: bs.blocksparse_fwd_plain(q, k, v, tables),
             4 * pair * active, io + nbytes(o, lse),
             "deepspeed_tpu/ops/pallas/blocksparse.py:107",
             "one k-block left out of one row's table", sdpa_fwd_ms),
            ("blocksparse_bwd_dq", lambda: bs.blocksparse_bwd_dq(*args),
             lambda: bs.blocksparse_bwd_dq_plain(*args),
             6 * pair * active, io + nbytes(do, lse, delta, q),
             "deepspeed_tpu/ops/pallas/blocksparse.py:187",
             "one k-block left out of one row's table",
             sdpa_fwd_ms + sdpa_bwd_ms),
            ("blocksparse_bwd_dkv", lambda: bs.blocksparse_bwd_dkv(*args),
             lambda: bs.blocksparse_bwd_dkv_plain(*args),
             8 * pair * active, io + nbytes(do, lse, delta) + 2 * nbytes(o),
             "deepspeed_tpu/ops/pallas/blocksparse.py:250",
             "one q-block left out of one column's transposed table",
             sdpa_fwd_ms + sdpa_bwd_ms)):
        ms = time_graph_ms(lambda i, fn=fn: fn(), n=8, reps=5)
        call_ms = time_ms(fn, reps=5, inner=4)
        plain_ms = time_ms(plain, reps=3, inner=1, warmup=1)
        # the work list the launch walks, and reruns bit for bit
        work = tables.dkv_work() if name == "blocksparse_bwd_dkv" \
            else tables.row_work()
        extra = dict(work.summary(), reruns_bit_equal=True)
        bit_equal_reruns(name, fn)
        record(rows, name, "train_bert_sparse", replaces, checks[name], ms,
               call_ms, plain_ms, bound(nbytes_, flops), info, fault,
               library_ms=lib, lse_err=lse_err if "fwd" in name else None,
               extra=extra)
    del args, o, lse, delta, mask
    torch.cuda.empty_cache()
    # bench_sparse_attention's comparison: the port's dense non-causal
    # flash forward + backward at the same shape
    f_o, f_lse = fa.flash_attention_fwd(q4, k4, v4)
    flash_ms = time_graph_ms(lambda i: fa.flash_attention_fwd(q4, k4, v4),
                             n=4, reps=5) + time_graph_ms(
        lambda i: fa.flash_attention_bwd(q4, k4, v4, f_o, f_lse, do4),
        n=4, reps=5)
    sparse_ms = sum(row["ms"] for row in rows)
    emit({"phase": "bert_kernels", "cases": info,
          "sparse_fwd_bwd_us": sparse_ms * 1e3,
          "dense_flash_us": flash_ms * 1e3,
          "dense_over_sparse": flash_ms / sparse_ms,
          "sdpa_masked_fwd_us": sdpa_fwd_ms * 1e3,
          "sdpa_masked_fwd_bwd_us": (sdpa_fwd_ms + sdpa_bwd_ms) * 1e3})
    del q, k, v, do, q4, k4, v4, do4, f_o, f_lse
    torch.cuda.empty_cache()
    return rows


def train_bert_sparse_phase(warmup=BERT_WARMUP, steps=BERT_STEPS):
    """``initialize`` + ``train_batch`` of BertForPreTraining at BERT-large's
    full width and depth, every layer's attention through the block-sparse
    kernels; returns (engine, batch, the run's kernel launches)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.bert import BertForPreTraining
    from deepspeed_tpu_torch.ops.cuda import builder
    cfg = bert_model_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _, _, _ = ds.initialize(config=bert_ds_config(),
                                    model=BertForPreTraining(cfg),
                                    model_parameters=bert_weights(cfg),
                                    loss_fn=bert_loss)
    batch = bert_batch(cfg)
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
        raise AssertionError(f"non-finite BERT loss: {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"the BERT loss did not fall: {timed}")
    L = cfg.num_hidden_layers
    expect = {name: L * steps for name in BLOCKSPARSE_KERNELS}
    if launches != expect:             # flash, the dense path: none
        raise AssertionError(f"train_bert_sparse launch counts {launches} "
                             f"!= {expect}")
    layout = np.asarray(cfg.sparsity_config.make_layout(BERT_SEQ))
    block = cfg.sparsity_config.block
    n_params = sum(p.numel() for p in engine.module.parameters())
    tokens = BERT_BATCH * BERT_SEQ
    dense_flops = 6 * n_params * tokens
    attn_flops = 12 * L * BERT_BATCH * int(layout.sum()) * block * block \
        * cfg.hidden_size // cfg.num_attention_heads
    flops = dense_flops + attn_flops
    step_s = wall_s / steps
    emit({"phase": "train_bert_sparse", "model": "bert_large", "layers": L,
          "params": n_params, "batch": BERT_BATCH, "seq": BERT_SEQ,
          "positions": f"{BERT_POSITIONS} extended to {BERT_SEQ}",
          "sparse_attention": BERT_SPARSE,
          "layout_density": float(layout.mean()),
          "active_blocks_a_layer": int(layout.sum()),
          "steps": steps, "warmup_steps": warmup,
          "init_and_warmup_s": init_s, "step_ms": step_s * 1e3,
          "tokens_per_s": tokens / step_s,
          "sequences_per_s": BERT_BATCH / step_s,
          "model_tflops_per_step": flops / 1e12,
          "attention_tflops_per_step": attn_flops / 1e12,
          "model_tflop_per_s": flops / step_s / 1e12,
          "mfu": flops / step_s / BF16_FLOP_PER_S,
          "step_floor_ms": flops / BF16_FLOP_PER_S * 1e3,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_per_step":
              {k: v / steps for k, v in launches.items()},
          "losses": losses})
    return engine, batch, launches


class _PlainBlockSparse(torch.autograd.Function):
    """Block-sparse attention through the kernels' plain versions, forward
    and backward: the BERT grad check's reference. With ``drop`` the dq
    pass leaves the last k-block of every row out: its planted fault."""

    @staticmethod
    def forward(ctx, q, k, v, tables, drop):
        from deepspeed_tpu_torch.ops.cuda import blocksparse as bs
        o, lse = bs.blocksparse_fwd_plain(q, k, v, tables)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.drop = tables, drop
        return o

    @staticmethod
    def backward(ctx, do):
        from deepspeed_tpu_torch.ops.cuda import blocksparse as bs
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o).sum(-1)
        do = do.to(q.dtype)
        t = ctx.tables
        dq = bs.blocksparse_bwd_dq_plain(q, k, v, do, lse, delta,
                                         drop_last(t) if ctx.drop else t)
        dk, dv = bs.blocksparse_bwd_dkv_plain(q, k, v, do, lse, delta, t)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None


class PlainSparseAttention:
    """A stand-in for a layer's ``SparseSelfAttention`` that runs
    ``_PlainBlockSparse`` on the same layout."""

    def __init__(self, op, drop=False):
        self.op, self.drop = op, drop

    def __call__(self, q, k, v, key_padding_mask=None, **_):
        from deepspeed_tpu_torch.ops.cuda import blocksparse as bs
        B, H, S, D = q.shape
        block = self.op.sparsity_config.block
        tables = bs.layout_tables(self.op.get_layout(S), S, block, H,
                                  q.device)
        flat = [t.reshape(B * H, S, D).contiguous() for t in (q, k, v)]
        o = _PlainBlockSparse.apply(*flat, tables, self.drop)
        return o.to(q.dtype).reshape(B, H, S, D)


def bert_loss_and_grads(model, batch, plain=None):
    """(loss, gradients) of one step of ``model``, every layer's sparse
    attention swapped for ``PlainSparseAttention(op, drop=plain)`` unless
    ``plain`` is None (the kernels)."""
    layers = list(model.bert.encoder.layer)
    ops = [layer.sparse for layer in layers]
    if plain is not None:
        for layer, op in zip(layers, ops):
            layer.sparse = PlainSparseAttention(op, drop=plain)
    try:
        loss = bert_loss(model, batch)
        grads = torch.autograd.grad(loss.float(), list(model.parameters()))
    finally:
        for layer, op in zip(layers, ops):
            layer.sparse = op
    return float(loss.detach()), grads


def bert_grad_check_phase(n_layer=2, batch=16, seq=256):
    """A 2-layer BERT of BERT-large's width with the same layout config,
    ``batch`` sequences of ``seq`` tokens, as ``initialize`` holds it on
    the card: one step's loss and gradients through the kernels against
    the same step through their plain versions, every leaf at
    BERT_GRAD_RTOL (rows measured against at least BERT_GRAD_FLOOR of
    their leaf's RMS row norm) and the loss at LOSS_RTOL; then through a
    planted fault (the last k-block of every row left out of dq), which
    the same limit must reject."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.bert import BertForPreTraining
    from deepspeed_tpu_torch.ops.cuda import tolerance
    cfg = bert_model_config(n_layer)
    engine, _, _, _ = ds.initialize(config=bert_ds_config(batch),
                                    model=BertForPreTraining(cfg),
                                    model_parameters=bert_weights(cfg),
                                    loss_fn=bert_loss)
    data = bert_batch(cfg, batch=batch, seq=seq)
    model, names = engine.module, engine.param_names
    loss_k, grads_k = bert_loss_and_grads(model, data)
    loss_p, grads_p = bert_loss_and_grads(model, data, plain=False)
    loss_f, grads_f = bert_loss_and_grads(model, data, plain=True)

    def errs(grads):
        return {name: tolerance.row_rel_err(g, w, floor=BERT_GRAD_FLOOR)
                for name, g, w in zip(names, grads, grads_p)}

    def top(e, n=6):
        return dict(sorted(e.items(), key=lambda kv: -kv[1])[:n])
    err, f_err = errs(grads_k), errs(grads_f)
    worst = max(err, key=err.get)
    f_worst = max(f_err, key=f_err.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emit({"phase": "bert_grad_check", "layers": n_layer, "batch": batch,
          "seq": seq, "leaves": len(err), "loss_kernels": loss_k,
          "loss_plain": loss_p, "loss_rel_err": loss_rel,
          "loss_limit": LOSS_RTOL, "max_row_rel_err": err[worst],
          "worst_leaf": worst,
          "median_row_rel_err": float(np.median(list(err.values()))),
          "limit": BERT_GRAD_RTOL, "floor": BERT_GRAD_FLOOR,
          "worst_leaves": top(err),
          "fault": "the last k-block of every row left out of dq (plain "
                   "versions)", "fault_worst_leaves": top(f_err),
          "fault_loss": loss_f, "fault_max_row_rel_err": f_err[f_worst],
          "fault_worst_leaf": f_worst,
          "fault_leaves_rejected": sum(e > BERT_GRAD_RTOL
                                       for e in f_err.values())})
    if not err[worst] <= BERT_GRAD_RTOL:
        raise AssertionError(f"BERT grad check: {worst} row-relative error "
                             f"{err[worst]:.3g} > {BERT_GRAD_RTOL}")
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"BERT grad check: loss {loss_k} vs plain "
                             f"{loss_p} ({loss_rel:.3g} > {LOSS_RTOL})")
    if not f_err[f_worst] > BERT_GRAD_RTOL:
        raise AssertionError(f"BERT grad check: a planted fault "
                             f"({f_err[f_worst]:.3g}) passes the check")


def traffic(cfg, rs):
    """The main path's requests: N_REQUESTS greedy requests, prompts of
    32-768 tokens, 16-64 new tokens, drawn from ``rs``."""
    import deepspeed_tpu_torch.serving as serving
    return [serving.Request(i, rs.randint(0, cfg.vocab_size,
                                          rs.randint(32, 769)),
                            max_new_tokens=int(rs.randint(16, 65)))
            for i in range(N_REQUESTS)]


def serve_geometry(eng, family):
    """(model name, layers, KV heads, head dim, bytes of one cached K and V
    row of one layer, layer weight bytes, LM head bytes, dense-forward
    oracle ``f(p, cfg, ids, prompt_len)``, expected launches per tick step
    by kernel) of a serving engine; ``family`` "gpt2", "gpt2_int8",
    "llama" or "llama_int8" (int8 weights and pool)."""
    p, cfg = eng.adapter.p, eng.adapter.cfg
    if family in ("gpt2", "gpt2_int8"):
        from deepspeed_tpu_torch.models.gpt2_inference import \
            dense_logits as dense_gpt2
        int8 = family == "gpt2_int8"

        def dense_logits(p, cfg, ids, S):
            # int8: fp32 over the dequantized codes, the decode steps
            # attending over K/V rounded through the pool's codes
            if int8:
                return dense_gpt2(p, cfg, ids, torch.float32,
                                  kv_quant_from=S)
            return dense_gpt2(p, cfg, ids)
        mats = tuple(m + sfx for m in ("attn_qkvw", "attn_ow", "inter_w",
                                        "output_w")
                     for sfx in ("", "_scale") if m + sfx in p)
        name = "gpt2_large_int8" if int8 else "gpt2_large"
        L, Hkv, head = cfg.n_layer, cfg.n_head, "wte"
        per_step = ("ln_qkv_stacked", "decode_attention_paged",
                    "out_ffn_stacked")
        row_bytes = 2 * Hkv * ((cfg.head_dim + 4) if int8
                               else cfg.head_dim * 2)
    else:
        from deepspeed_tpu_torch.models import llama_inference as li
        int8 = family == "llama_int8"

        def dense_logits(p, cfg, ids, S):
            # fp32: a bf16 dense pass of 32 layers parts from the fp32 one
            # by more than the paged decode does (LLAMA_INIT_STD); over an
            # int8 pool the decode steps attend over K/V rounded through
            # its codes
            return li.dense_logits(p, cfg, ids, torch.float32,
                                   kv_quant_from=S if int8 else None)
        mats = li.LAYER_MATS + tuple(m + li.SCALE for m in li.LAYER_MATS
                                     if m + li.SCALE in p)
        name = "llama_7b_int8" if int8 else "llama_7b"
        L, Hkv, head = cfg.n_layers, cfg.kv_heads, "head"
        per_step = ("ln_qkv_stacked", "decode_attention_paged",
                    "out_ffn_stacked") + (
            () if eng.adapter.fused_proj() else ("matvec_stacked",))
        # a row of K and of V: D codes and an fp32 scale each, or D bf16
        row_bytes = 2 * Hkv * ((cfg.head_dim + 4) if int8
                               else cfg.head_dim * 2)
    return (name, L, Hkv, cfg.head_dim, row_bytes,
            nbytes(*(p[m] for m in mats)), nbytes(p[head]), dense_logits,
            per_step)


def teacher_forced(rows, gen_tok):
    """(largest logit gap, in bf16 units, and the positions where a
    runner-up decoder would fail) of generated tokens ``gen_tok`` [n]
    against oracle logits ``rows`` [n, V]: the gap of each token's logit
    below the row's maximum, in bf16 units of the maximum."""
    top2 = rows.topk(2, dim=-1).values
    gap = top2[:, 0] - rows.gather(1, gen_tok[:, None])[:, 0]
    spacing = top2[:, 0] - top2[:, 1]
    # bf16 keeps 8 significant bits: a unit is 2**(exponent - 7)
    ulp = torch.exp2(torch.floor(torch.log2(
        top2[:, 0].abs().clamp_min(1e-30))) - 7)
    return gap, spacing, ulp


def serve_phase(eng, cfg, family):
    """N_REQUESTS greedy requests through ``eng`` (a fresh batcher on its
    adapter): exact launch counts, every budget finished, a teacher-
    forced check against a dense forward of the plain versions, TTFT,
    tokens/s and ms per decode step beside its floor. Returns the run's
    launches."""
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.ops.cuda import builder
    name, L, Hkv, D, row_bytes, w_layers, w_head, dense_logits, per_step = \
        serve_geometry(eng, family)
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
    expect = {"flash_attention_fwd": L * st["prefills"],
              **{k: L * st["tick_steps"] for k in per_step}}
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
    # the floor of a decode step: the layer weights and the LM head read
    # once, plus the cached K/V rows the step's live slots attend over (a
    # request's k-th decode step, at position S + k, reads S + k + 1 rows
    # of K and V in every layer); averaged over the run's steps
    kv_rows = sum(len(r.prompt) + k + 1 for r in res.values()
                  for k in range(len(r.generated) - 1))
    kv_bytes = kv_rows * L * row_bytes
    floor_ms = ((w_layers + w_head) * st["tick_steps"] + kv_bytes) \
        / st["tick_steps"] / HBM_BYTES_PER_S * 1e3
    # teacher-forced check: every request's tokens against a dense
    # forward of the plain versions (bf16 for GPT-2, fp32 for LLaMA), at
    # every generated position. The
    # planted fault is a decoder that takes the plain runner-up token
    # everywhere: it must fail at some position.
    gaps, spacings, ulps = [], [], []
    for rid in sorted(res):
        r = res[rid]
        toks = r.tokens()
        S = len(r.prompt)
        rows = dense_logits(eng.adapter.p, cfg, toks[:-1], S)[S - 1:]
        gen_tok = torch.as_tensor(toks[S:], device=rows.device).long()
        for acc, t in zip((gaps, spacings, ulps),
                          teacher_forced(rows, gen_tok)):
            acc.append(t)
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
    emit({"phase": {"gpt2": "serve", "gpt2_int8": "serve_gpt2_int8",
                    "llama": "serve_llama",
                    "llama_int8": "serve_llama_int8"}[family],
          "model": name, "layers": L,
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
          "floor_weight_bytes_per_step": w_layers + w_head,
          "floor_kv_bytes_per_step": kv_bytes / st["tick_steps"],
          "page_pool_occupancy_hwm": snap["page_pool"]["occupancy_hwm"],
          "launches": launches,
          "teacher_forced_oracle": {
              "gpt2": "bf16 dense", "llama": "fp32 dense",
              "gpt2_int8": "fp32 dense over the int8 weights, K/V of "
                           "decode steps rounded through the pool's "
                           "codes",
              "llama_int8": "fp32 dense over the int8 weights, K/V of "
                            "decode steps rounded through the pool's "
                            "codes"}[family],
          "teacher_forced_requests": len(res),
          "teacher_forced_positions": len(spacing),
          "teacher_forced_gap_limit_ulps": TF_ULPS,
          "teacher_forced_max_logit_gap": worst,
          "teacher_forced_max_gap_ulps": worst_ulps,
          "teacher_forced_not_plain_argmax": int((gap > 0).sum()),
          "plain_top2_spacing_median": float(spacing.median()),
          "runner_up_fault_rejected_at": n_fault_caught})
    return launches


def gpt2_generate_config():
    """bench.py's bench_decode model: GPT-2 large at vocab 50304 and ctx
    2048, bf16."""
    from deepspeed_tpu_torch.models.gpt2 import gpt2_large
    return gpt2_large(vocab_size=TRAIN_VOCAB, n_positions=GEN_CTX,
                      dtype=torch.bfloat16)


def gpt2_generate_kernel_rows(p, p8, cfg, gen):
    """generate()'s kernels at GPT-2 large's shapes, each against its plain
    version and a planted fault, held at B 1 and 8. The per-token route's
    (path generate_gpt2_step, timed at B 8 over the 36 layers of the int8
    weights ``p8``): ln_qkv_int8, out_ffn_int8, decode_attention_int8 over
    an int8 cache at ctx 2048, pos 2034, the scales past pos NaN, and
    kv_quant_int8 into one layer of it; matvec_int8 (no model calls it, as
    in JAX: path null, no launches); the fast route's, timed at its B 1:
    ln_qkv_stacked, out_ffn_stacked and decode_attention_stacked over
    ``p8`` and the int8 cache with kv_quant_int8 into it (generate_gpt2),
    and over the bf16 weights ``p`` and a bf16 cache (generate_gpt2_bf16).
    """
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    dev = p8["wte"].device
    L, E, H, D, Fd = (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_dim,
                      cfg.n_inner)
    eps = cfg.layer_norm_epsilon
    lids = torch.arange(L, dtype=torch.int32, device=dev)
    cyc = itertools.cycle(range(L))
    Bs = (1, 8)
    B = Bs[-1]
    results = []
    s_ = {n: p8[n + "_scale"] for n in ("attn_qkvw", "attn_ow", "inter_w",
                                        "output_w")}

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
            cfg.dtype)

    def timed(kernel, plain):
        """(graph-replay ms, eager ms, plain ms) of ``kernel(l, lid)`` and
        ``plain(l)`` over the model's layers."""
        def eager():
            l = next(cyc)
            kernel(l, lids[l])
        return (time_graph_ms(lambda i: kernel(i, lids[i]), n=L),
                time_ms(eager),
                time_ms(lambda: plain(next(cyc)), reps=10, inner=1))

    # -- ln_qkv_int8: LayerNorm + [B, 1280] . int8 [1280, 3840] + b
    def qkv_args(l, w=None):
        return (p8["ln1_w"][l], p8["ln1_b"][l],
                p8["attn_qkvw"][l] if w is None else w, s_["attn_qkvw"][l],
                p8["attn_qkvb"][l])
    f_w = p8["attn_qkvw"][LAYER].clone()
    f_w[-32:] = 0                           # the last 32 weight rows
    checks, xs = [], {}
    for b in Bs:
        xs[b] = x = rnd(b, E)
        checks.append(held("ln_qkv_int8",
                           dk.ln_qkv_int8(x, *qkv_args(LAYER), eps=eps),
                           dk.ln_qkv_int8_plain(x, *qkv_args(LAYER), eps),
                           dk.ln_qkv_int8_plain(x, *qkv_args(LAYER, f_w),
                                                eps)))
    x = xs[B]
    ms, call_ms, plain_ms = timed(
        lambda l, lid: dk.ln_qkv_int8(x, *qkv_args(l), eps=eps),
        lambda l: dk.ln_qkv_int8_plain(x, *qkv_args(l), eps))
    N = 3 * E
    record(results, "ln_qkv_int8", "generate_gpt2_step",
           "deepspeed_tpu/ops/pallas/decode.py:225", checks, ms, call_ms,
           plain_ms, bound(nbytes(x) + E * N + 4 + 2 * E * 4 + N * 4
                           + B * N * 2, 2 * B * E * N),
           [{"B": b, "E": E, "N": N, "weights": "int8"} for b in Bs],
           "the last 32 of the 1280 weight rows dropped (B 1 and 8)",
           extra=proj_extra("ln_qkv_int8",
                            lambda: dk.ln_qkv_int8(x, *qkv_args(LAYER),
                                                   eps=eps),
                            B, 1, [(E, N, "ln_bf16")]))

    # -- out_ffn_int8: three launches over int8 [1280, 1280], [1280, 5120],
    # [5120, 1280]
    def ffn_args(l, wp=None):
        return (p8["attn_ow"][l] if wp is None else wp, s_["attn_ow"][l],
                p8["attn_ob"][l], p8["ln2_w"][l], p8["ln2_b"][l],
                p8["inter_w"][l], s_["inter_w"][l], p8["inter_b"][l],
                p8["output_w"][l], s_["output_w"][l], p8["output_b"][l])
    f_wp = p8["attn_ow"][LAYER].clone()
    f_wp[-64:] = 0                          # the last 64 rows of Wp
    checks, ctxs = [], {}
    for b in Bs:
        ctxs[b] = ctx = rnd(b, E)
        x = xs[b]
        checks.append(held("out_ffn_int8",
                           dk.out_ffn_int8(ctx, x, *ffn_args(LAYER), eps=eps),
                           dk.out_ffn_int8_plain(ctx, x, *ffn_args(LAYER),
                                                 eps=eps),
                           dk.out_ffn_int8_plain(ctx, x,
                                                 *ffn_args(LAYER, f_wp),
                                                 eps=eps)))
    ctx, x = ctxs[B], xs[B]
    ms, call_ms, plain_ms = timed(
        lambda l, lid: dk.out_ffn_int8(ctx, x, *ffn_args(l), eps=eps),
        lambda l: dk.out_ffn_int8_plain(ctx, x, *ffn_args(l), eps=eps))
    record(results, "out_ffn_int8", "generate_gpt2_step",
           "deepspeed_tpu/ops/pallas/decode.py:320", checks, ms, call_ms,
           plain_ms, bound((E * E + 2 * E * Fd) + 3 * 4 + (6 * E + Fd) * 4
                           + 3 * B * E * 2, 2 * B * (E * E + 2 * E * Fd)),
           [{"B": b, "E": E, "F": Fd, "launches_per_call": 3,
             "weights": "int8"} for b in Bs],
           "the last 64 of the 1280 rows of Wp dropped (B 1 and 8)",
           extra=proj_extra("out_ffn_int8",
                            lambda: dk.out_ffn_int8(ctx, x, *ffn_args(LAYER),
                                                    eps=eps),
                            B, 1, gpt2_ffn_launches(E, Fd)))

    # -- matvec_int8: [B, 1280] . int8 [1280, 5120] + b, gelu_tanh
    def mv_args(l, w=None):
        return (p8["inter_w"][l] if w is None else w, s_["inter_w"][l],
                p8["inter_b"][l])
    f_w1 = p8["inter_w"][LAYER].clone()
    f_w1[-32:] = 0
    checks = []
    for b in Bs:
        x = xs[b]
        checks.append(held("matvec_int8",
                           dk.matvec_int8(x, *mv_args(LAYER), act="gelu_tanh"),
                           dk.matvec_int8_plain(x, *mv_args(LAYER),
                                                act="gelu_tanh"),
                           dk.matvec_int8_plain(x, *mv_args(LAYER, f_w1),
                                                act="gelu_tanh")))
    x = xs[B]
    ms, call_ms, plain_ms = timed(
        lambda l, lid: dk.matvec_int8(x, *mv_args(l), act="gelu_tanh"),
        lambda l: dk.matvec_int8_plain(x, *mv_args(l), act="gelu_tanh"))
    record(results, "matvec_int8", None,
           "deepspeed_tpu/ops/pallas/decode.py:63", checks, ms, call_ms,
           plain_ms, bound(nbytes(x) + E * Fd + 4 + Fd * 4 + B * Fd * 2,
                           2 * B * E * Fd),
           [{"B": b, "K": E, "N": Fd, "act": "gelu_tanh", "weights": "int8"}
            for b in Bs], "the last 32 of the 1280 weight rows dropped",
           extra=proj_extra("matvec_int8",
                            lambda: dk.matvec_int8(x, *mv_args(LAYER),
                                                   act="gelu_tanh"),
                            B, 1, [(E, Fd, "copy")]))

    # -- decode_attention_int8 over one layer's [B, H, L, D] int8 cache
    pos_i = GEN_CTX - 80 + GEN_LONG - 2          # the long run's last step
    n = pos_i + 1
    shape = (L, B, H, GEN_CTX, D)
    kc, vc = (torch.randint(-128, 128, shape, generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(shape[:4], generator=gen, device=dev) * 0.01 + 0.002
              for _ in range(2))
    for t in (ks, vs):
        t[..., n:] = float("nan")           # rows past pos must not be read
    pos = torch.tensor([pos_i], dtype=torch.int32, device=dev)
    checks, qs = [], {}
    for b in Bs:
        qs[b] = q = rnd(b, H, 1, D)
        args = (kc[LAYER, :b], ks[LAYER, :b], vc[LAYER, :b], vs[LAYER, :b])
        got = dk.decode_attention_int8(q, *args, pos)
        if not torch.isfinite(got).all():
            raise AssertionError("decode_attention_int8 read past pos")
        checks.append(held("decode_attention_int8", got,
                           dk.decode_attention_int8_plain(q, *args, pos_i),
                           dk.decode_attention_int8_plain(q, *args,
                                                          pos_i - 16)))
    # the per-token step's call: its new K/V rows (column slices of the
    # packed qkv output) appended by the attention call at pos
    q = qs[B]

    def new_rows(b):
        qkv = rnd(b, 3 * E)
        return qkv[:, E:2 * E].view(b, H, D), qkv[:, 2 * E:].view(b, H, D)
    k3, v3 = new_rows(B)

    def attend(l, fold=True):
        rows = dict(new_k=k3, new_v=v3) if fold else {}
        return dk.decode_attention_int8(q, kc[l], ks[l], vc[l], vs[l], pos,
                                        **rows)
    every = torch.arange(B, device=dev)
    check, fold, ms, _ = fold_extra(
        attend, lambda: dk.decode_attention_int8_plain(
            q, kc[LAYER], ks[LAYER], vc[LAYER], vs[LAYER], pos_i),
        "decode_attention_int8", k3, v3,
        (kc, ks.unsqueeze(3), vc, vs.unsqueeze(3)), every,
        torch.full_like(every, pos_i), every, n=L)
    checks.append(check)
    call_ms = time_ms(lambda: attend(next(cyc)))

    def plain():
        l = next(cyc)
        dk.stacked_append_plain(kc[l][None], vc[l][None], pos, 0, k3, v3,
                                ks[l][None, :, :, None],
                                vs[l][None, :, :, None])
        dk.decode_attention_int8_plain(q, kc[l], ks[l], vc[l], vs[l], pos_i)
    plain_ms = time_ms(plain, reps=10, inner=1)

    def att_bound(b, row_bytes, cache):
        return bound(b * n * H * row_bytes * 2 + 2 * b * H * D * 2 + 4
                     + append_bytes(b, H, D, cache), 4 * b * n * H * D)
    record(results, "decode_attention_int8", "generate_gpt2_step",
           "deepspeed_tpu/ops/pallas/decode.py:110", checks, ms, call_ms,
           plain_ms, att_bound(B, D + 4, (kc, ks, vc, vs)),
           [{"B": b, "H": H, "D": D, "L": GEN_CTX, "pos": pos_i}
            for b in Bs] + [{"B": B, "new_rows": True}],
           "the last 16 keys dropped (B 1 and 8)",
           extra={**fold, **attn_plan("decode_attention_int8",
                                      lambda: attend(LAYER), q, GEN_CTX)})

    # -- kv_quant_int8 at head dim 64 as the per-token route runs it: into
    # one layer's cache (no layer index)
    def kv_case(b, stacks, lid):
        """(k3, v3, write, read) of kv_quant_int8 into the first b batch
        rows of ``stacks`` (k codes, k scale [.., 1, L], v codes, v
        scale) at row pos_i: ``write(lid)`` at layer ``lid``, or into a
        one-layer view (no layer index) when ``lid`` is None."""
        qkv = rnd(b, 3 * E)
        k3, v3 = qkv[:, E:2 * E].view(b, H, D), qkv[:, 2 * E:].view(b, H, D)
        at = 0 if lid is None else LAYER
        return (k3, v3,
                lambda l: dk.kv_quant_int8(k3, v3, out=stacks,
                                           layer=None if lid is None else l,
                                           rows=pos),
                lambda: tuple(t[at, :b, :, pos_i] if t.dtype == torch.int8
                              else t[at, :b, :, :, pos_i] for t in stacks))
    one = [tuple(t[LAYER:LAYER + 1, :b] for t in (kc, ks[..., None, :], vc,
                                                  vs[..., None, :]))
           for b in Bs]
    cases = [kv_case(b, st, None) for b, st in zip(Bs, one)][::-1]
    kv_quant_row(results, "generate_gpt2_step", *cases[0],
                 lambda kernel, plain: timed(lambda l, lid: kernel(lid),
                                             plain),
                 "deepspeed_tpu/ops/pallas/decode.py:279", more=cases[1:])

    # -- the fast route (B 1 in generate_gpt2 over the int8 codes and
    # caches, in generate_gpt2_bf16 over the bf16 weights and cache), each
    # row held at B 1 and 8 and timed at B 1: ln_qkv_stacked and
    # out_ffn_stacked (GPT-2's int8 contract over the codes),
    # decode_attention_stacked over the int8 cache above and a bf16 one,
    # kv_quant_int8 into the int8 stacks
    Bf = Bs[0]
    lid_l = lids[LAYER]
    ctxs = {b: rnd(b, E) for b in Bs}
    k5, v5 = ks.unsqueeze(3), vs.unsqueeze(3)
    kf, vf = (rnd(*shape, scale=0.5) for _ in range(2))
    for w, path, int8 in ((p8, "generate_gpt2", True),
                          (p, "generate_gpt2_bf16", False)):
        (Wq, sq), (Wp, sp), (W1, s1), (W2, s2) = gi.weight_stacks(w)
        wb = Wq.element_size()
        key = ({"ln_qkv": "ln_qkv_stacked[ln,int8]",
                "out_ffn": "out_ffn_stacked[int8]",
                "attn": "decode_attention_stacked[int8,d64]"} if int8 else
               {"ln_qkv": "ln_qkv_stacked", "out_ffn": "out_ffn_stacked",
                "attn": "decode_attention_stacked"})
        weights = "int8" if int8 else "bf16"
        qkv_args = (w["ln1_w"], w["ln1_b"], Wq, sq, w["attn_qkvb"])
        f_args = [t[LAYER:LAYER + 1].clone() for t in qkv_args]
        f_args[2][:, -32:] = 0              # the last 32 weight rows
        checks = [held(key["ln_qkv"],
                       dk.ln_qkv_stacked(xs[b], *qkv_args, lid_l, eps=eps),
                       dk.ln_qkv_stacked_plain(xs[b], *qkv_args, LAYER, eps),
                       dk.ln_qkv_stacked_plain(xs[b], *f_args, 0, eps))
                  for b in Bs]
        x = xs[Bf]
        ms, call_ms, plain_ms = timed(
            lambda l, lid: dk.ln_qkv_stacked(x, *qkv_args, lid, eps=eps),
            lambda l: dk.ln_qkv_stacked_plain(x, *qkv_args, l, eps))
        record(results, "ln_qkv_stacked", path,
               "deepspeed_tpu/ops/pallas/decode.py:496", checks, ms, call_ms,
               plain_ms, bound(nbytes(x) + E * N * wb + 4 + 2 * E * 4
                               + N * 4 + Bf * N * 2, 2 * Bf * E * N),
               [{"B": b, "E": E, "N": N, "L": L, "weights": weights}
                for b in Bs],
               "the last 32 of the 1280 weight rows dropped (B 1 and 8)",
               limit=key["ln_qkv"],
               extra=proj_extra("ln_qkv_stacked",
                                lambda: dk.ln_qkv_stacked(x, *qkv_args,
                                                          lid_l, eps=eps),
                                Bf, wb, [(E, N, "ln_bf16")]))

        ffn = (Wp, sp, w["attn_ob"], w["ln2_w"], w["ln2_b"], W1, s1,
               w["inter_b"], W2, s2, w["output_b"])
        f_ffn = [t[LAYER:LAYER + 1].clone() for t in ffn]
        f_ffn[0][:, -64:] = 0               # the last 64 rows of Wp
        checks = [held(key["out_ffn"],
                       dk.out_ffn_stacked(ctxs[b], xs[b], *ffn, lid_l,
                                          eps=eps),
                       dk.out_ffn_stacked_plain(ctxs[b], xs[b], *ffn, LAYER,
                                                eps=eps),
                       dk.out_ffn_stacked_plain(ctxs[b], xs[b], *f_ffn, 0,
                                                eps=eps))
                  for b in Bs]
        ctx = ctxs[Bf]
        ms, call_ms, plain_ms = timed(
            lambda l, lid: dk.out_ffn_stacked(ctx, x, *ffn, lid, eps=eps),
            lambda l: dk.out_ffn_stacked_plain(ctx, x, *ffn, l, eps=eps))
        record(results, "out_ffn_stacked", path,
               "deepspeed_tpu/ops/pallas/decode.py:1000", checks, ms,
               call_ms, plain_ms,
               bound((E * E + 2 * E * Fd) * wb + 3 * 4 + (6 * E + Fd) * 4
                     + 3 * Bf * E * 2, 2 * Bf * (E * E + 2 * E * Fd)),
               [{"B": b, "E": E, "F": Fd, "launches_per_call": 3,
                 "weights": weights} for b in Bs],
               "the last 64 of the 1280 rows of Wp dropped (B 1 and 8)",
               limit=key["out_ffn"],
               extra=proj_extra("out_ffn_stacked",
                                lambda: dk.out_ffn_stacked(ctx, x, *ffn,
                                                           lid_l, eps=eps),
                                Bf, wb, gpt2_ffn_launches(E, Fd)))

        # the cache at B 1: the first batch row of the B-8 one, contiguous
        full = (kc, vc, dict(k_scale=k5, v_scale=v5)) if int8 else \
            (kf, vf, {})
        first = (full[0][:, :Bf].contiguous(), full[1][:, :Bf].contiguous(),
                 {k: t[:, :Bf].contiguous() for k, t in full[2].items()})
        checks = []
        for b, (kk, vv, kw) in zip(Bs, (first, full)):
            qb = qs[b]
            got = dk.decode_attention_stacked(qb, kk, vv, pos, lid_l, **kw)
            if not torch.isfinite(got).all():
                raise AssertionError("decode_attention_stacked read past pos")
            checks.append(held(
                key["attn"], got,
                dk.decode_attention_stacked_plain(qb, kk, vv, pos, LAYER,
                                                  **kw),
                dk.decode_attention_stacked_plain(qb, kk, vv, pos - 16,
                                                  LAYER, **kw)))
        # the fast loop's call: the step's new K/V rows appended by the
        # attention call at pos
        kk, vv, kw = first
        q1 = qs[Bf]
        k1, v1 = new_rows(Bf)
        cache = (kk, kw["k_scale"], vv, kw["v_scale"]) if int8 else (kk, vv)

        def attend(l, fold=True):
            rows = dict(new_k=k1, new_v=v1) if fold else {}
            return dk.decode_attention_stacked(q1, kk, vv, pos, lids[l],
                                               **kw, **rows)
        one = torch.arange(Bf, device=dev)
        check, fold, ms, _ = fold_extra(
            attend, lambda: dk.decode_attention_stacked_plain(
                q1, kk, vv, pos, LAYER, **kw), key["attn"], k1, v1, cache,
            one, torch.full_like(one, pos_i), one, n=L)
        checks.append(check)
        call_ms = time_ms(lambda: attend(next(cyc)))

        def plain():
            l = next(cyc)
            dk.stacked_append_plain(kk, vv, pos, l, k1, v1, **kw)
            dk.decode_attention_stacked_plain(q1, kk, vv, pos, l, **kw)
        plain_ms = time_ms(plain, reps=10, inner=1)
        # SDPA computes the same function over a bf16 cache's live rows
        lib_ms = None if int8 else time_graph_ms(
            lambda i: torch.nn.functional.scaled_dot_product_attention(
                q1, kk[i, :, :, :n], vv[i, :, :, :n]), n=L)
        record(results, "decode_attention_stacked", path,
               "deepspeed_tpu/ops/pallas/decode.py:643", checks, ms, call_ms,
               plain_ms, att_bound(Bf, D + 4 if int8 else 2 * D, cache),
               [{"B": b, "Hkv": H, "R": 1, "D": D, "L": GEN_CTX,
                 "pos": pos_i, "cache": weights} for b in Bs]
               + [{"B": Bf, "new_rows": True}],
               "the last 16 keys dropped (B 1 and 8)", library_ms=lib_ms,
               limit=key["attn"],
               extra={**fold, **attn_plan(key["attn"], lambda: attend(LAYER),
                                          q1, GEN_CTX)})
        if int8:
            st1 = (first[0], first[2]["k_scale"], first[1],
                   first[2]["v_scale"])
            cases = [kv_case(b, st, lid_l)
                     for b, st in zip(Bs, (st1, (kc, k5, vc, v5)))]
            kv_quant_row(results, path, *cases[0],
                         lambda kernel, plain: timed(
                             lambda l, lid: kernel(lid), plain),
                         "deepspeed_tpu/ops/pallas/decode.py:279",
                         more=cases[1:])
            del first, st1
    del kc, vc, ks, vs, k5, v5, kf, vf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    decode_pos_sweeps(dev, gen, "gpt2_large", H, 1, D)
    return results


def gpt2_generate(gen, profile=False):
    """GPT-2 large at bench_decode's config, random weights from seed 0
    quantized on the card (quantize_gpt2_inference_params), generate()'s
    kernel rows and its timed cases; returns (kernel rows, {path:
    launches})."""
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    from deepspeed_tpu_torch.models.gpt2 import init_params
    cfg = gpt2_generate_config()
    p = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p8 = gi.quantize_gpt2_inference_params(p)
    torch.cuda.synchronize()
    emit({"phase": "gpt2_generate_init", "model": "gpt2_large",
          "vocab": cfg.vocab_size, "ctx": cfg.n_positions,
          "params": cfg.num_params(),
          "quantize_s": time.perf_counter() - t0,
          "weight_gb": sum(nbytes(t) for t in p.values()) / 1e9,
          "int8_weight_gb": sum(nbytes(t) for t in p8.values()) / 1e9,
          "int8_layer_code_gb": sum(nbytes(t) for t in p8.values()
                                    if t.dtype == torch.int8) / 1e9})
    rows = gpt2_generate_kernel_rows(p, p8, cfg, gen)
    launches = gpt2_generate_phase(p, p8, cfg, profile)
    del p, p8
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows, launches


def gpt2_generate_phase(p, p8, cfg, profile=False):
    """``generate()`` at GPT-2 large as bench.py's bench_decode times it:
    per case a warm-up, then the best of 3 of t(68 new) - t(4 new) for 64
    decode steps, beside the floor of those steps (the layer weights and
    the LM head read once a step, plus the live K/V rows); launches
    counted per path, exactly (36 a decode step for each kernel of its
    route); the last row of each batch teacher-forced against the fp32
    dense oracle (over the int8 weights, every position attending over
    K/V rounded through the int8 cache's codes where the cache is int8);
    and the positions where the fast and per-token routes part at b1
    int8. Returns {path: launches}."""
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    from deepspeed_tpu_torch.ops.cuda import builder
    L, H, D = cfg.n_layer, cfg.n_head, cfg.head_dim
    S = GEN_CTX - 80
    steps = GEN_LONG - GEN_SHORT
    # the timed steps run at positions S + GEN_SHORT - 1 .. S + GEN_LONG - 2
    kv_rows = sum(S + k + 1 for k in range(GEN_SHORT - 1, GEN_LONG - 1))
    w_head = nbytes(p["wte"])
    launches, cases, long_toks = {}, [], {}
    for name, bs, qb, kv, scan, path in GPT2_GEN_CASES:
        w = p8 if qb else p
        w_layers = nbytes(*(t for k, t in w.items()
                            if k not in ("wte", "wpe")))
        row_bytes = 2 * H * ((D + 4) if kv else D * 2)
        prompt = np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(bs, S)).astype(np.int32)

        def run(new):
            toks = gi.generate(cfg, w, prompt, max_new_tokens=new,
                               max_out_tokens=GEN_CTX, quantize_bits=qb,
                               kv_cache_bits=kv, scan_decode=scan)
            int(toks[0, -1])             # the bench's fence: read a token
            return toks
        torch.cuda.synchronize()
        builder.launches.clear()         # count this case's runs only
        run(GEN_SHORT)
        run(GEN_LONG)
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            run(GEN_SHORT)
            t_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            toks = run(GEN_LONG)
            best = min(best, time.perf_counter() - t0 - t_s)
        got = dict(builder.launches)
        decode_steps = 4 * (GEN_SHORT - 1 + GEN_LONG - 1)
        # the new K/V rows go into the cache inside the attention launch:
        # no route launches kv_quant_int8
        if scan:            # the fast route: the stacked kernels
            kernels = ("ln_qkv_stacked", "decode_attention_stacked",
                       "out_ffn_stacked")
        elif qb:            # the fused int8 step
            kernels = ("ln_qkv_int8", "decode_attention_int8",
                       "out_ffn_int8")
        else:               # the general path over an int8 cache
            kernels = ("decode_attention_int8",)
        expect = {k: L * decode_steps for k in kernels}
        if got != expect:
            raise AssertionError(f"generate {name}: launches {got} != "
                                 f"{expect}")
        acc = launches.setdefault(path, {})
        for k, v in got.items():
            acc[k] = acc.get(k, 0) + v
        floor_s = (steps * (w_layers + w_head) + bs * kv_rows * L
                   * row_bytes) / HBM_BYTES_PER_S
        case = {"case": name, "batch": bs, "prompt": S, "ctx": GEN_CTX,
                "weights": "int8" if qb else "bf16", "kv_cache_bits": kv,
                "route": "fast" if scan else "per-token", "path": path,
                "decode_tokens_per_s": bs * steps / best,
                "ms_per_decode_step": best / steps * 1e3,
                "floor_ms_per_step": floor_s / steps * 1e3,
                "floor_tokens_per_s": bs * steps / floor_s,
                "launches": got}
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError("token outside the vocabulary")
        # the batch's last row: a fault in the batch's indexing shows there
        ids = toks[bs - 1].tolist()
        rows = gi.dense_logits(w, cfg, ids[:-1], torch.float32,
                               kv_quant_from=0 if kv else None)[S - 1:]
        gap, spacing, ulp = teacher_forced(
            rows, torch.as_tensor(ids[S:], device=rows.device))
        del rows
        case.update(teacher_forced_row=bs - 1,
                    teacher_forced_max_gap_ulps=float((gap / ulp).max()),
                    teacher_forced_positions=len(gap),
                    runner_up_fault_rejected_at=int(
                        (spacing > TF_ULPS * ulp).sum()))
        if case["teacher_forced_max_gap_ulps"] > TF_ULPS:
            raise AssertionError(f"generate {name}: teacher-forced gap "
                                 f"{case['teacher_forced_max_gap_ulps']} "
                                 f"bf16 units > {TF_ULPS}")
        if case["runner_up_fault_rejected_at"] == 0:
            raise AssertionError(f"generate {name}: a runner-up decoder "
                                 f"passes the teacher-forced check")
        long_toks[name] = toks
        cases.append(case)
        torch.cuda.empty_cache()
    fast, step = long_toks["b1_int8_fast"], long_toks["b1_int8_step"]
    line = {"phase": "generate_gpt2", "model": "gpt2_large",
            "layers": L, "vocab": cfg.vocab_size, "new_tokens_timed": steps,
            "cases": cases, "launches": launches,
            "b1_int8_fast_vs_step_positions_differing":
                int((fast[0, S:] != step[0, S:]).sum()),
            "b1_int8_generated_positions": GEN_LONG}
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        prompt = np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(1, S)).astype(np.int32)
        for scan, key in ((True, "fast"), (False, "step")):
            torch.cuda.synchronize()
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                toks = gi.generate(cfg, p8, prompt, max_new_tokens=GEN_LONG,
                                   max_out_tokens=GEN_CTX, quantize_bits=8,
                                   kv_cache_bits=8, scan_decode=scan)
                int(toks[0, -1])
                wall_s = time.perf_counter() - t0
            busy = sum(e.device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       ) / 1e6
            line[f"profile_b1_int8_{key}"] = {
                "wall_s": wall_s, "device_busy_s": busy,
                "device_idle_share": 1.0 - busy / wall_s}
    emit(line)
    return launches


def generate_kernel_rows(eng, cfg, gen):
    """The dense fast path's kernels at its shapes: the flash forward of
    its b8 prompt pass (path generate_llama); decode_attention_stacked
    over int8 (generate_llama) and bf16 (generate_llama_kv0) caches of 8
    rows at ctx 2048, and kv_quant_int8 into the int8 one, each against
    its plain version and a planted fault. The int8 cache's scales past
    the position are NaN: rows there must not reach the result."""
    from deepspeed_tpu_torch.ops.cuda import decode as dk
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import tolerance
    dev = eng.adapter.device
    L, H, Hkv, D = cfg.n_layers, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    B, Lc = max(GEN_BATCHES), GEN_CTX
    results = []

    # -- flash_attention_fwd as the b8 prompt pass runs it: prompts of
    # GEN_CTX - 80 tokens padded to a multiple of 128, causal
    S = -(-(GEN_CTX - 80) // 128) * 128
    q, k, v = ((torch.randn(B, H, S, D, generator=gen, device=dev)
                ).to(cfg.dtype) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    # fault: every batch element attends to element 0's K/V, as a kernel
    # that left the batch out of its K/V offset would
    fault = fa.flash_attention_fwd_plain(q, k[:1].expand_as(k),
                                         v[:1].expand_as(v), causal=True)[0]
    checks = [held("flash_attention_fwd[d128]", o, o_ref, fault)]
    lse_err = tolerance.check_lse(lse, lse_ref)
    del o, lse, o_ref, lse_ref, fault
    torch.cuda.empty_cache()
    ms = time_graph_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal=True),
                       n=8)
    call_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                      reps=10, inner=3)
    plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, causal=True), reps=5, inner=1)
    lib_ms = time_graph_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), n=8)
    record(results, "flash_attention_fwd", "generate_llama",
           "deepspeed_tpu/ops/pallas/flash_attention.py:122", checks, ms,
           call_ms, plain_ms,
           bound(4 * B * H * S * D * 2 + B * H * S * 4,
                 4 * B * H * D * S * (S + 1) // 2),
           [{"B": B, "S": S, "H": H, "Hkv": H, "D": D, "causal": True}],
           "every batch element given element 0's K/V", library_ms=lib_ms,
           lse_err=lse_err, limit="flash_attention_fwd[d128]",
           extra=flash_variants(q, k, v, True, n=8))
    del q, k, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pos_i = GEN_CTX - 80 + GEN_LONG - 2          # the long run's last step
    lids = eng.adapter._layer_ids
    cyc = itertools.cycle(range(L))
    pos = torch.tensor([pos_i], dtype=torch.int32, device=dev)

    def timed(kernel, plain):
        return (time_graph_ms(lambda i: kernel(lids[i]), n=L),
                time_ms(lambda: kernel(lids[next(cyc)])),
                time_ms(lambda: plain(next(cyc)), reps=5, inner=1))

    shape = (L, B, Hkv, Lc, D)
    codes = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(shape[:3] + (1, Lc), generator=gen, device=dev)
              * 0.01 + 0.002 for _ in range(2)]
    for sc in scales:
        sc[..., pos_i + 1:] = float("nan")
    q = (torch.randn(B, Hkv, H // Hkv, D, generator=gen, device=dev)
         ).to(cfg.dtype)
    kw = dict(k_scale=scales[0], v_scale=scales[1])
    n = pos_i + 1
    for name, kc, vc, kw, path, row_bytes, key in (
            ("int8", codes[0], codes[1], kw, "generate_llama", D + 4,
             "decode_attention_stacked[int8]"),
            ("bf16", None, None, {}, "generate_llama_kv0", 2 * D,
             "decode_attention_stacked")):
        if kc is None:
            del codes, scales
            kc, vc = ((torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.float32) * 0.5).to(cfg.dtype)
                      for _ in range(2))
        got = dk.decode_attention_stacked(q, kc, vc, pos, lids[LAYER], **kw)
        if not torch.isfinite(got).all():
            raise AssertionError("decode_attention_stacked read past pos")
        checks = [held(key, got, dk.decode_attention_stacked_plain(
            q, kc, vc, pos, LAYER, **kw), dk.decode_attention_stacked_plain(
            q, kc, vc, pos - 16, LAYER, **kw))]
        # the fast loop's call: the step's new K/V rows (column slices of
        # the packed qkv output) appended by the attention call at pos
        qkv = (torch.randn(B, (H + 2 * Hkv) * D, generator=gen,
                           device=dev)).to(cfg.dtype)
        k3 = qkv[:, H * D:(H + Hkv) * D].view(B, Hkv, D)
        v3 = qkv[:, (H + Hkv) * D:].view(B, Hkv, D)
        cache = (kc, kw["k_scale"], vc, kw["v_scale"]) if kw else (kc, vc)

        def attend(l, fold=True):
            rows = dict(new_k=k3, new_v=v3) if fold else {}
            return dk.decode_attention_stacked(q, kc, vc, pos, lids[l], **kw,
                                               **rows)
        every = torch.arange(B, device=dev)
        check, fold, ms, _ = fold_extra(
            attend, lambda: dk.decode_attention_stacked_plain(
                q, kc, vc, pos, LAYER, **kw), key, k3, v3, cache, every,
            torch.full_like(every, pos_i), every, n=L)
        checks.append(check)
        call_ms = time_ms(lambda: attend(next(cyc)))

        def plain():
            l = next(cyc)
            dk.stacked_append_plain(kc, vc, pos, l, k3, v3, **kw)
            dk.decode_attention_stacked_plain(q, kc, vc, pos, l, **kw)
        plain_ms = time_ms(plain, reps=5, inner=1)
        lib_ms = None
        if not kw:
            qs = q.reshape(B, H, 1, D)
            lib_ms = time_graph_ms(
                lambda i: torch.nn.functional.scaled_dot_product_attention(
                    qs, kc[i, :, :, :n], vc[i, :, :, :n]), n=L)
        record(results, "decode_attention_stacked", path,
               "deepspeed_tpu/ops/pallas/decode.py:643", checks, ms, call_ms,
               plain_ms, bound(B * n * Hkv * row_bytes * 2 + 2 * nbytes(q)
                               + 4 + append_bytes(B, Hkv, D, cache),
                               4 * B * n * H * D),
               [{"B": B, "Hkv": Hkv, "R": H // Hkv, "D": D, "L": Lc,
                 "pos": pos_i, "cache": name, "new_rows": True}],
               "the last 16 keys dropped", library_ms=lib_ms, limit=key,
               extra={**fold, **attn_plan(key, lambda: attend(LAYER), q,
                                          Lc)})
        if kw:
            kv_quant_row(
                results, path, k3, v3,
                lambda lid: dk.kv_quant_int8(k3, v3, out=cache, layer=lid,
                                             rows=pos),
                lambda: (kc[LAYER][:, :, pos_i],
                         cache[1][LAYER][:, :, 0, pos_i][..., None],
                         vc[LAYER][:, :, pos_i],
                         cache[3][LAYER][:, :, 0, pos_i][..., None]),
                timed, "deepspeed_tpu/ops/pallas/decode.py:279")
        del kc, vc, kw, cache
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    decode_pos_sweeps(dev, gen, "llama_7b", Hkv, H // Hkv, D, Bs=(1, B))
    return results


def generate_phase(eng, cfg, profile=False):
    """``llama_fast_generate`` over the int8 engine's weights, as bench.py's
    bench_llama_decode times it: per batch size a warm-up, then the best
    of 3 of t(68 new) - t(4 new) for 64 decode steps, beside the floor of
    those steps (the int8 layer weights and the LM head read once a step,
    plus the live int8 K/V rows and their scales), and the best t(4 new)
    itself (``t4_ms``: the prompt pass and 3 steps); the last row of each
    batch held by the teacher-forced check. Then a short bf16-cache case
    (kv_cache_bits=0).
    Returns {path: launches}."""
    from deepspeed_tpu_torch.models import llama_inference as li
    from deepspeed_tpu_torch.ops.cuda import builder
    p = eng.adapter.p
    name, L, Hkv, D, row_bytes, w_layers, w_head, dense_logits, _ = \
        serve_geometry(eng, "llama_int8")
    S = GEN_CTX - 80

    def run(prompt, new, kv=8):
        toks = li.llama_fast_generate(cfg, p, prompt, max_new_tokens=new,
                                      max_out_tokens=GEN_CTX,
                                      kv_cache_bits=kv)
        int(toks[0, -1])                 # the bench's fence: read a token
        return toks

    steps = GEN_LONG - GEN_SHORT
    # the timed steps run at positions S + GEN_SHORT - 1 .. S + GEN_LONG - 2
    kv_rows = sum(S + k + 1 for k in range(GEN_SHORT - 1, GEN_LONG - 1))
    torch.cuda.synchronize()
    builder.launches.clear()             # count the main path's run only
    cases, n_runs = [], 0
    for bs in GEN_BATCHES:
        prompt = np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(bs, S)).astype(np.int32)
        run(prompt, GEN_SHORT)
        run(prompt, GEN_LONG)
        best = best_t4 = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            run(prompt, GEN_SHORT)
            t_s = time.perf_counter() - t0
            best_t4 = min(best_t4, t_s)
            t0 = time.perf_counter()
            toks = run(prompt, GEN_LONG)
            best = min(best, time.perf_counter() - t0 - t_s)
        n_runs += 8
        floor_s = (steps * (w_layers + w_head) + bs * kv_rows * L
                   * row_bytes) / HBM_BYTES_PER_S
        case = {"batch": bs, "prompt": S, "ctx": GEN_CTX,
                # bench.py's t(4 new): the prompt pass and 3 decode steps
                "t4_ms": best_t4 * 1e3,
                "decode_tokens_per_s": bs * steps / best,
                "ms_per_decode_step": best / steps * 1e3,
                "floor_ms_per_step": floor_s / steps * 1e3,
                "floor_tokens_per_s": bs * steps / floor_s}
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError("token outside the vocabulary")
        # the batch's last row: a fault in the batch's indexing shows there
        ids = toks[bs - 1].tolist()
        rows = dense_logits(p, cfg, ids[:-1], S)[S - 1:]
        gap, spacing, ulp = teacher_forced(
            rows, torch.as_tensor(ids[S:], device=rows.device))
        case.update(teacher_forced_row=bs - 1,
                    teacher_forced_max_gap_ulps=float((gap / ulp).max()),
                    teacher_forced_positions=len(gap),
                    runner_up_fault_rejected_at=int(
                        (spacing > TF_ULPS * ulp).sum()))
        del rows
        if case["teacher_forced_max_gap_ulps"] > TF_ULPS:
            raise AssertionError(f"fast path b{bs}: teacher-forced gap "
                                 f"{case['teacher_forced_max_gap_ulps']}"
                                 f" bf16 units > {TF_ULPS}")
        if case["runner_up_fault_rejected_at"] == 0:
            raise AssertionError("a runner-up decoder passes the fast "
                                 "path's teacher-forced check")
        cases.append(case)
    launches = {"generate_llama": dict(builder.launches)}
    decode_steps = len(GEN_BATCHES) * 4 * (GEN_SHORT - 1 + GEN_LONG - 1)
    fused = li.fused_proj(cfg, p["o_w"])
    per_step = ("ln_qkv_stacked", "decode_attention_stacked",
                "out_ffn_stacked") + (() if fused else ("matvec_stacked",))
    expect = {"flash_attention_fwd": L * n_runs,
              **{k: L * decode_steps for k in per_step}}
    if launches["generate_llama"] != expect:
        raise AssertionError(f"fast path launches "
                             f"{launches['generate_llama']} != {expect}")

    # the bf16 cache: a short batch of 8
    k0 = GEN_KV0
    prompt = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(k0["batch"], k0["prompt"])).astype(np.int32)
    torch.cuda.synchronize()
    builder.launches.clear()
    toks = run(prompt, k0["new"], kv=0)
    launches["generate_llama_kv0"] = dict(builder.launches)
    want = L * (k0["new"] - 1)
    if launches["generate_llama_kv0"].get("decode_attention_stacked") != want \
            or "kv_quant_int8" in launches["generate_llama_kv0"]:
        raise AssertionError(f"bf16-cache launches "
                             f"{launches['generate_llama_kv0']}")
    gaps = []
    for row in toks.tolist():
        rows = li.dense_logits(p, cfg, row[:-1], torch.float32)[
            k0["prompt"] - 1:]
        gap, _, ulp = teacher_forced(
            rows, torch.as_tensor(row[k0["prompt"]:], device=rows.device))
        gaps.append(float((gap / ulp).max()))
    if max(gaps) > TF_ULPS:
        raise AssertionError(f"bf16-cache fast path: teacher-forced gap "
                             f"{max(gaps)} bf16 units > {TF_ULPS}")
    line = {"phase": "generate_llama_int8", "model": name, "layers": L,
            "kv_cache_bits": 8, "weights": "int8", "new_tokens_timed": steps,
            "cases": cases, "launches": launches["generate_llama"],
            "kv0": {**k0, "launches": launches["generate_llama_kv0"],
                    "teacher_forced_max_gap_ulps": max(gaps)}}
    if profile:
        # b1 and b8 under torch.profiler: the device's idle share of the
        # run (prompt pass and GEN_LONG - 1 decode steps) and the wall
        # time a decode step beside its device time, the host's share
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        for bs in (1, max(GEN_BATCHES)):
            prompt = np.random.RandomState(0).randint(
                0, cfg.vocab_size, size=(bs, S)).astype(np.int32)
            run(prompt, GEN_SHORT)
            torch.cuda.synchronize()
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(prompt, GEN_LONG)
                wall_s = time.perf_counter() - t0
            busy = sum(e.device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       ) / 1e6
            line[f"profile_b{bs}"] = {
                "wall_s": wall_s, "device_busy_s": busy,
                "device_idle_share": 1.0 - busy / wall_s,
                "decode_steps": GEN_LONG - 1}
    emit(line)
    return launches


def profile_phase(eng, cfg, model, reqs_seed=1):
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
    emit({"phase": "profile", "model": model, "wall_s": wall_s,
          "device_busy_s": busy_us / 1e6,
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
    emit({"phase": "host_profile", "model": model, "wall_s": wall_s,
          "tick_steps": main.stats["tick_steps"],
          "functions": [{"name": f"{fn[0].split('/')[-1]}:{fn[1]}:{fn[2]}",
                         "calls": st[1], "tottime_ms": st[2] * 1e3,
                         "cumtime_ms": st[3] * 1e3}
                        for fn, st in rows]})


# ------------------------------------------------------------ MoQ training

def moq_ds_config(moq=None, **more):
    """bench.py's GPT-2 large training config with a quantize_training
    block (default: MOQ)."""
    return dict(train_ds_config(), quantize_training=dict(moq or MOQ),
                **more)


def moq_sr_ds_config():
    """MOQ's bits, period and offset with asymmetric stochastic rounding,
    the blend with the unquantized weights (ratio falling by 0.25 a
    boundary) and progressive layer drop."""
    moq = dict(MOQ, quantize_algo={"q_type": "asymmetric",
                                   "rounding": "stochastic"},
               fp16_mixed_quantize={"enabled": True,
                                    "quantize_change_ratio": 0.25})
    return moq_ds_config(moq, progressive_layer_drop=dict(PLD))


def moq_leaves(model):
    """The leaves MoQ quantizes in ``model``'s JAX layout, [(path, names,
    stacked)], and their element count."""
    from deepspeed_tpu_torch.runtime.quantize import eligible_leaves
    named = dict(model.named_parameters())
    leaves = eligible_leaves(named, model.jax_paths())
    return leaves, sum(named[n].numel() for _, names, _ in leaves
                       for n in names)


def moq_leaf_pieces(scan_layers):
    """The shapes of the pieces of each leaf MoQ's kernel takes at a
    boundary of GPT-2 large in the given layout, in leaf order (a stacked
    leaf: its L layer tensors); the model is made on the meta device."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    with torch.device("meta"):
        model = GPT2LMHeadModel(dataclasses.replace(
            train_model_config(), scan_layers=scan_layers))
    leaves, _ = moq_leaves(model)
    return [[tuple(model.get_parameter(n).shape) for n in names]
            for _, names, _ in leaves]


def moq_leaf_shapes(scan_layers):
    """The shape of each leaf of ``moq_leaf_pieces`` (a stacked leaf as
    [L, .])."""
    return [((len(p),) if len(p) > 1 else ()) + p[0]
            for p in moq_leaf_pieces(scan_layers)]


def moq_groups(shape, groups=MOQ["quantize_groups"]):
    """The Quantizer's groups for a leaf: q_groups where they divide it."""
    return groups if math.prod(shape) % groups == 0 else 1


def quantize_fault(x, bits, groups, sym, kind):
    """A planted fault of quantize, made with the plain version: "scale",
    one scale over the whole tensor; "chunk", the last R tile of each
    group (of the kernel's work list for x as one leaf) left out of the
    reduction."""
    from deepspeed_tpu_torch.ops.cuda import quantize as cq
    flat = x.reshape(groups, -1).float()
    if kind == "scale":
        scale, zero = cq.qparams_plain(flat.reshape(1, -1), bits, sym)
    else:
        wl = cq.work_list([([x.numel()], x.element_size(), groups)])
        r = wl.kind == 0
        o = np.lexsort((wl.start[r], wl.group[r]))
        g, st, ct = wl.group[r][o], wl.start[r][o], wl.count[r][o]
        last = np.append(g[1:] != g[:-1], True)
        mask = torch.zeros(x.numel(), dtype=torch.bool, device=x.device)
        for s0, c in zip(st[last].tolist(), ct[last].tolist()):
            mask[s0:s0 + c] = True
        m = mask.view(groups, -1)
        # the left-out elements take the mean of the rest of their group,
        # which moves neither its min nor its max
        fill = flat.masked_fill(m, 0.0).sum(-1, keepdim=True) / (~m).sum(
            -1, keepdim=True)
        scale, zero = cq.qparams_plain(torch.where(m, fill, flat), bits, sym)
    return cq.apply_plain(flat, scale, zero, bits).reshape(x.shape).to(
        x.dtype)


def hold_table(table, sym, ratio=None, faults=("scale",)):
    """One ``quantize_leaves`` launch over ``table`` into fresh outputs:
    every leaf bit for bit against ``quantize_leaves_plain``, and each
    planted fault of ``faults`` (quantize_fault's kinds, then the blend)
    rejected on every leaf; (max abs error, least fault row-relative
    error)."""
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.ops.cuda import quantize as cq
    outs = [[torch.empty_like(p) for p in pieces] for pieces, _, _ in table]
    n0 = builder.launches["quantize"]
    cq.quantize_leaves(table, sym, ratio=ratio, outs=outs)
    if builder.launches["quantize"] - n0 != 1:
        raise AssertionError(f"quantize_leaves over {len(table)} leaves: "
                             f"{builder.launches['quantize'] - n0} launches")
    errs, f_errs = [], []
    for (pieces, bits, groups), dst in zip(table, outs):
        x = torch.cat([p.reshape(-1) for p in pieces])
        want = torch.cat([w.reshape(-1) for w in cq.quantize_leaves_plain(
            [(pieces, bits, groups)], sym, ratio=ratio,
            outs=[[torch.empty_like(p) for p in pieces]])[0]])
        got = torch.cat([d.reshape(-1) for d in dst]).view(groups, -1)
        want = want.view(groups, -1)
        for fault in faults:
            bad = quantize_fault(x, bits, groups, sym, fault)
            if ratio is not None:
                bad = x * ratio + bad * (1.0 - ratio)
            abs_err, _, f_rel = held("quantize", got, want,
                                     bad.view(groups, -1))
            errs.append(abs_err)
            f_errs.append(f_rel)
        del x, want, got, bad
    del outs
    return max(errs), min(f_errs)


def hold_nearest(x, bits_list, groups, sym, fault):
    """Nearest rounding of x at each of ``bits_list``: the kernel bit for
    bit against the plain version, the planted fault ``fault``
    (quantize_fault's kind) rejected; (max abs error, least fault
    row-relative error)."""
    from deepspeed_tpu_torch.ops.cuda import quantize as cq
    errs, f_errs = [], []
    for bits in bits_list:
        got = cq.quantize(x, bits, groups, sym)
        want = cq.quantize_plain(x, bits, groups, sym)
        bad = quantize_fault(x, bits, groups, sym, fault)
        abs_err, _, f_rel = held("quantize", got, want, bad)
        errs.append(abs_err)
        f_errs.append(f_rel)
        del got, want, bad
    return max(errs), min(f_errs)


def sr_vector(bits, sym, shape, groups, full=False):
    """x of ``shape`` in ``groups`` groups of n values at known fractions
    (1/8, 1/4, 3/8) of a step above whole codes, each group's range
    pinned by anchors at the extreme codes, on the card: (x [groups, n],
    t = x / scale or (x - min) / scale). Group g is scaled by 2^-(g % 4):
    each group has its own scale and the same t. The values sit on the
    lowest 64 codes (|t| <= 64), or with ``full`` on every code (as many
    as n holds): there t reaches 2^(bits - 1) or 2^bits, and fl(t + u)
    rounds at t's ulp (2^-9 at t ~ 2^14), which biases floor(t + u) in
    the kernel, the plain version and JAX's quantize_jnp alike."""
    from deepspeed_tpu_torch.ops.cuda import quantize as cq
    n = math.prod(shape) // groups
    hi = cq.qrange(bits, sym)[1]
    first = -hi if sym else 0.0
    span = hi - first if full else min(hi - first, 64.0)
    idx = torch.arange(n, device="cuda", dtype=torch.float64)
    codes = first + torch.remainder(idx, span)
    frac = torch.tensor([0.125, 0.25, 0.375], device="cuda",
                        dtype=torch.float64)[(idx % 3).long()]
    row = (codes + frac) * 2.0 ** -7
    row[0], row[1] = hi * 2.0 ** -7, first * 2.0 ** -7
    g_scale = 2.0 ** -torch.remainder(
        torch.arange(groups, device="cuda", dtype=torch.float64), 4)
    x = (g_scale[:, None] * row[None, :]).float()
    scale, zero = cq.qparams_plain(x, bits, sym)
    return x, (x / scale if sym else (x - zero) / scale)


def sr_check(draw, bits, sym, shape, groups, full=False):
    """Stochastic rounding over SR_DRAWS draws of sr_vector: (every code
    floor(t) or ceil(t) in the code range, the summed code error, its
    sigma, |mean code error|). Each code's error has mean 0 and variance
    f (1 - f), f = t - floor(t), when t + u is exact."""
    from deepspeed_tpu_torch.ops.cuda import quantize as cq
    x, t = sr_vector(bits, sym, shape, groups, full)
    scale, zero = cq.qparams_plain(x, bits, sym)
    lo, hi = cq.qrange(bits, sym)
    fl, ce = torch.floor(t), torch.ceil(t)
    total = torch.zeros((), dtype=torch.float64, device="cuda")
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    for _ in range(SR_DRAWS):
        out = draw(x).float()
        q = torch.round(out / scale if sym else (out - zero) / scale)
        ok &= ((q == fl) | (q == ce)).all() & (q >= lo).all() & (q <= hi).all()
        total += (q - t).double().sum()
    f = (t - fl).double()
    sigma = float((f * (1 - f)).sum().sqrt()) * SR_DRAWS ** 0.5
    return bool(ok), float(total), sigma, \
        abs(float(total)) / (SR_DRAWS * t.numel())


def hold_stochastic(label, bits, sym, shape, groups, gen):
    """Stochastic rounding of sr_vector at ``shape`` in ``groups`` groups
    held statistically: every code floor(t) or ceil(t) and the summed
    code error within SR_Z sigma of 0, the planted fault u = 0.5 beyond
    it, and over every code the kernel's summed error within SR_Z sigma
    of the plain version's; the row's checks."""
    from deepspeed_tpu_torch.ops.cuda import quantize as cq

    def kernel(v):
        return cq.quantize(v, bits, groups, sym, True, gen)

    def plain(v):
        return cq.quantize_plain(v, bits, groups, sym, True, gen)

    def nearest_fault(v):
        scale, zero = cq.qparams_plain(v, bits, sym)
        return cq.apply_plain(v, scale, zero, bits, torch.full_like(v, 0.5))
    ok, total, sigma, mean_err = sr_check(kernel, bits, sym, shape, groups)
    f_ok, f_total, _, _ = sr_check(nearest_fault, bits, sym, shape, groups)
    full_ok, k_full, sigma_full, _ = sr_check(kernel, bits, sym, shape,
                                              groups, True)
    _, p_full, _, _ = sr_check(plain, bits, sym, shape, groups, True)
    z, f_z = total / sigma, f_total / sigma
    z_diff = (k_full - p_full) / (sigma_full * math.sqrt(2.0))
    if not (ok and abs(z) <= SR_Z):
        raise AssertionError(f"quantize {label}: stochastic rounding "
                             f"fails its check (codes {ok}, z {z:.3g})")
    if f_ok and abs(f_z) <= SR_Z:
        raise AssertionError(f"quantize {label}: the planted fault "
                             f"(u = 0.5) passes (z {f_z:.3g})")
    if not (full_ok and abs(z_diff) <= SR_Z):
        raise AssertionError(
            f"quantize {label}: over every code the kernel's summed "
            f"error parts from the plain version's (z {z_diff:.3g})")
    return {"max_abs_err": mean_err, "held": "statistically",
            "draws": SR_DRAWS, "codes_floor_or_ceil": ok and full_ok,
            "z": z, "z_limit": SR_Z, "fault_z": f_z,
            "z_every_code_kernel": k_full / sigma_full,
            "z_every_code_plain": p_full / sigma_full,
            "z_every_code_kernel_vs_plain": z_diff}


def quantize_kernel_phase(gen):
    """``quantize`` on the MoQ paths' shapes. Nearest rounding is held bit
    for bit against the plain version beside a planted fault; stochastic
    rounding statistically (the fault u = 0.5). Rows: c_fc [1280, 5120]
    fp32 in 8 groups (15 and 8 bits), wte [50304, 1280] in 8 groups with
    an outlier in the last chunk, a bf16 input, stochastic symmetric 8
    bits; train_moq_sr's leaf set (the scan layout: wte, wpe and the
    stacked [36, .] bias and LayerNorm leaves, 8 groups, asymmetric) at
    each of its shapes, nearest and stochastic; each timed in place by
    CUDA-graph replay. Then a whole train_moq boundary (GPT-2 large's 146
    leaves of the unrolled layout, 8 groups): every leaf held bit for bit
    at the run's first and last bits, then timed against its 1.85 ms
    bound. No single PyTorch call computes the grouped scale and the
    rounding (``torch.fake_quantize_per_channel_affine`` takes the scale
    as an input): library_ms is null."""
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.ops.cuda import quantize as cq
    from deepspeed_tpu_torch.ops.cuda import tolerance
    replaces = "deepspeed_tpu/ops/pallas/quantize.py:109"
    results = []
    faults = {"scale": "one scale over the whole tensor",
              "chunk": "the last R tile of each group left out of its "
                       "reduction (an outlier placed there)",
              "tile": "the last R tile of each group left out of its "
                      "reduction (an outlier at each group's end)",
              "u": "u = 0.5 (nearest rounding, half up)"}

    def rnd(shape, dtype=torch.float32):
        return (0.02 * torch.randn(shape, generator=gen, device="cuda")).to(
            dtype)

    def row(path, label, x, groups, bits, sym, stochastic, checks, fault):
        ms = time_graph_ms(lambda i: cq.quantize(
            x, bits, groups, sym, stochastic, out=x))
        call_ms = time_ms(lambda: cq.quantize(x, bits, groups, sym,
                                              stochastic, out=x))
        plain_ms = time_ms(lambda: cq.quantize_plain(
            x, bits, groups, sym, stochastic), reps=5, inner=1)
        # each element read and written once; ~10 fp32 operations
        b_ms, b_by = bound(2 * nbytes(x), 10 * x.numel(), FP32_FLOP_PER_S)
        results.append({
            "name": "quantize", "path": path, "route": "cuda",
            "source": "deepspeed_tpu_torch/csrc/quantize.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": checks["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
        emit({"phase": "kernel", "name": "quantize", "path": path,
              "case": label, "shape": list(x.shape),
              "dtype": str(x.dtype).replace("torch.", ""), "groups": groups,
              "bits": bits, "sym": sym, "stochastic": stochastic,
              "kernel_us": ms * 1e3, "call_us": call_ms * 1e3,
              "plain_us": plain_ms * 1e3, "bound_us": b_ms * 1e3,
              "bound_by": b_by, "pct_of_bound": 100.0 * b_ms / ms,
              "library_us": None, "fault": faults[fault], **checks})

    def nearest_row(path, label, x, groups, bits_list, sym, fault):
        err, f_err = hold_nearest(x, bits_list, groups, sym, fault)
        row(path, label, x, groups, bits_list[0], sym, False,
            {"max_abs_err": err, "held": "bit for bit",
             "bits_held": list(bits_list),
             "row_rtol": tolerance.ROW_RTOL["quantize"],
             "fault_row_rel_err": f_err}, fault)

    cases = (("c_fc", (1280, 5120), torch.float32, (15, 8), "scale"),
             ("wte", (50304, 1280), torch.float32, (15, 12), "chunk"),
             ("c_fc_bf16", (1280, 5120), torch.bfloat16, (8,), "scale"))
    for label, shape, dtype, bits_list, fault in cases:
        x = rnd(shape, dtype)
        if fault == "chunk":          # an outlier in the last chunk
            x.view(-1)[-1] = 0.2
        nearest_row("train_moq", label, x, moq_groups(shape), bits_list,
                    True, fault)
        del x
    shape = (1280, 5120)
    row("train_moq_sr", "c_fc_sr", rnd(shape), moq_groups(shape), 8, True,
        True, hold_stochastic("c_fc_sr", 8, True, shape, moq_groups(shape),
                              gen), "u")
    # train_moq_sr's leaf set: asymmetric, at its run's first and last bits
    sr_bits = (MOQ_SCHEDULE[0], MOQ_SCHEDULE[MOQ_SR_WARMUP + MOQ_SR_STEPS - 1])
    for shape in dict.fromkeys(moq_leaf_shapes(scan_layers=True)):
        label, groups = "x".join(map(str, shape)), moq_groups(shape)
        nearest_row("train_moq_sr", f"sr_leaf_{label}", rnd(shape), groups,
                    sr_bits, False, "scale")
        row("train_moq_sr", f"sr_leaf_{label}_stochastic", rnd(shape),
            groups, sr_bits[0], False, True,
            hold_stochastic(label, sr_bits[0], False, shape, groups, gen),
            "u")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # a whole boundary of train_moq: GPT-2 large's 146 leaves in one
    # launch, each held at the run's first and last bits, then timed in
    # place; an outlier at each group's end, in its last R tile, of
    # another size in each group (so that one scale for all is wrong)
    shapes = moq_leaf_shapes(scan_layers=False)
    tensors = [rnd(shape) for shape in shapes]
    for t in tensors:
        groups = moq_groups(t.shape)
        t.view(groups, -1)[:, -1] = 0.1 * torch.arange(
            1, groups + 1, device=t.device, dtype=t.dtype)
    n_elems = sum(t.numel() for t in tensors)
    moq_bits = (MOQ_SCHEDULE[0], MOQ_SCHEDULE[-1])
    errs, f_errs = zip(*(hold_table(
        [([t], bits, moq_groups(t.shape)) for t in tensors], True,
        faults=("scale", "chunk")) for bits in moq_bits))
    table = [([t], moq_bits[0], moq_groups(t.shape)) for t in tensors]
    n0 = builder.launches["quantize"]
    cq.quantize_leaves(table, True)
    launches = builder.launches["quantize"] - n0
    if launches != 1:
        raise AssertionError(f"a train_moq boundary took {launches} launches")
    ms = time_graph_ms(lambda i: cq.quantize_leaves(table, True), n=4)
    call_ms = time_ms(lambda: cq.quantize_leaves(table, True), reps=10,
                      inner=1)
    host_us = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cq.quantize_leaves(table, True)
        host_us.append((time.perf_counter() - t0) * 1e6)
    plain_ms = time_ms(lambda: cq.quantize_leaves_plain(table, True),
                       reps=3, inner=1, warmup=1)
    b_ms, b_by = bound(2 * 4 * n_elems, 10 * n_elems, FP32_FLOP_PER_S)
    # what one read-and-write pass over the boundary's bytes reaches here
    src = torch.empty(n_elems, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = time_graph_ms(lambda i: dst.copy_(src), n=4)
    del src, dst
    results.append({
        "name": "quantize", "path": "train_moq", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/quantize.cu",
        "replaces": replaces, "launches": 0, "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None})
    emit({"phase": "kernel", "name": "quantize", "path": "train_moq",
          "case": "boundary", "leaves": len(tensors),
          "launches_a_boundary": launches, "elements": n_elems,
          "kernel_ms": ms, "call_ms": call_ms,
          "host_us_median": statistics.median(host_us),
          "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
          "pct_of_bound": 100.0 * b_ms / ms, "copy_ms": copy_ms,
          "work_list": work_list_summary(table),
          "max_abs_err": max(errs), "held": "bit for bit, every leaf",
          "bits_held": list(moq_bits),
          "row_rtol": tolerance.ROW_RTOL["quantize"],
          "fault": [faults["scale"], faults["tile"]],
          "fault_row_rel_err": min(f_errs)})
    del tensors, table
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # a whole boundary of train_moq_sr: its 10 leaves (each stacked leaf
    # its 36 layer tensors) in one launch, asymmetric, blended at 0.75:
    # held bit for bit with nearest rounding at its run's first and last
    # bits, then timed in place with stochastic rounding
    table = []
    for shapes in moq_leaf_pieces(scan_layers=True):
        pieces = [rnd(shape) for shape in shapes]
        table.append((pieces, sr_bits[0], moq_groups(
            (sum(p.numel() for p in pieces),))))
    n_elems = sum(p.numel() for pieces, _, _ in table for p in pieces)
    errs, f_errs = zip(*(hold_table(
        [(pieces, bits, groups) for pieces, _, groups in table], False,
        ratio=MOQ_SR_RATIOS[0]) for bits in sr_bits))
    ms = time_graph_ms(lambda i: cq.quantize_leaves(
        table, False, True, MOQ_SR_RATIOS[0]), n=8)
    plain_ms = time_ms(lambda: cq.quantize_leaves_plain(
        table, False, True, MOQ_SR_RATIOS[0]), reps=3, inner=1, warmup=1)
    b_ms, b_by = bound(2 * 4 * n_elems, 10 * n_elems, FP32_FLOP_PER_S)
    results.append({
        "name": "quantize", "path": "train_moq_sr", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/quantize.cu",
        "replaces": replaces, "launches": 0, "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None})
    emit({"phase": "kernel", "name": "quantize", "path": "train_moq_sr",
          "case": "boundary", "leaves": len(table),
          "pieces": sum(len(pieces) for pieces, _, _ in table),
          "elements": n_elems, "stochastic": True,
          "ratio": MOQ_SR_RATIOS[0], "kernel_ms": ms, "plain_ms": plain_ms,
          "bound_ms": b_ms, "bound_by": b_by,
          "pct_of_bound": 100.0 * b_ms / ms,
          "work_list": work_list_summary(table),
          "max_abs_err": max(errs),
          "held": "bit for bit, every leaf, nearest rounding with the blend",
          "bits_held": list(sr_bits),
          "row_rtol": tolerance.ROW_RTOL["quantize"],
          "fault": faults["scale"], "fault_row_rel_err": min(f_errs)})
    del table
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


def work_list_summary(table):
    """The work list of one launch over ``table``: tiles, windows, and
    the largest group in MB."""
    from deepspeed_tpu_torch.ops.cuda import quantize as cq
    wl = cq.work_list([([p.numel() for p in pieces],
                        pieces[0].element_size(), groups)
                       for pieces, _, groups in table])
    return {"tiles": int(len(wl.kind)), "groups": int(len(wl.need)),
            "windows": int(wl.window.max()) + 1,
            "largest_group_mb": float(wl.group_bytes.max()) / 1e6,
            "tile_bytes": cq.TILE_BYTES, "window_bytes": cq.WINDOW_BYTES,
            "lag_tiles": cq.LAG_TILES,
            "blocks_a_sm": cq.BLOCKS_PER_SM}


def _run_moq(engine, batch, warmup, steps, each_step):
    """``warmup + steps`` train_batch steps; ``each_step(i)`` after each.
    Returns (losses, the timed steps' wall seconds, their launches,
    quantize launches a step, MoQ boundaries' device ms, their host µs,
    the plain version's calls). The boundaries are timed between CUDA
    events around ``_moq_boundary`` (device) and by the host's clock
    around the same call (host: what it takes to enqueue, no
    synchronize); the plain version is counted by a wrapper put in its
    place for the run."""
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.ops.cuda import quantize as cq
    plain, plain_calls, events, host_us = cq.quantize_plain, [0], [], []

    def counting(*a, **k):
        plain_calls[0] += 1
        return plain(*a, **k)
    boundary = engine._moq_boundary

    def timed_boundary(*a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        boundary(*a)
        host_us.append((time.perf_counter() - t0) * 1e6)
        end.record()
        events.append((start, end))
    cq.quantize_plain, engine._moq_boundary = counting, timed_boundary
    losses, per_step = [], []
    try:
        for i in range(warmup + steps):
            if i == warmup:
                torch.cuda.synchronize()
                builder.launches.clear()     # count the main path's run only
                events.clear()
                host_us.clear()
                t0 = time.perf_counter()
            n0 = builder.launches["quantize"]
            losses.append(engine.train_batch(batch))
            per_step.append(builder.launches["quantize"] - n0)
            each_step(i)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        cq.quantize_plain = plain
        del engine._moq_boundary
    losses = [float(x) for x in torch.stack(losses).cpu()]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite MoQ training loss: {losses}")
    boundary_ms = [s.elapsed_time(e) for s, e in events]
    return (losses, wall_s, dict(builder.launches), per_step, boundary_ms,
            host_us, plain_calls[0])


def _check_compute_copy(engine):
    """The bf16 compute copy equals the (quantized) masters cast to bf16."""
    for name, p, m in zip(engine.param_names, engine.compute_params,
                          engine.master):
        if not torch.equal(p.data, m.to(p.dtype)):
            raise AssertionError(f"{name}: the compute copy is not the "
                                 f"masters cast to {p.dtype}")


def train_moq_phase(warmup=TRAIN_WARMUP, steps=TRAIN_STEPS):
    """``initialize`` + ``train_batch`` of GPT-2 large (the train phase's
    model in the unrolled layout, where MoQ quantizes 146 leaves) with
    MOQ: the schedule, one quantize launch every step (its 146 leaves in
    one table) and no call of the plain version, each boundary's device
    time against its bound and its host time; after
    the last step every group of three sampled leaves holds at most 2^12
    values and the compute copy is the masters in bf16."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    cfg = dataclasses.replace(train_model_config(), scan_layers=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _, _, _ = ds.initialize(config=moq_ds_config(),
                                    model=GPT2LMHeadModel(cfg))
    batch = train_batch_ids()
    leaves, n_elems = moq_leaves(engine.module)
    bits = []
    (losses, wall_s, launches, per_step, boundary_ms, host_us,
     plain_calls) = _run_moq(
        engine, batch, warmup, steps,
        lambda i: bits.append(engine.quantizer.q_start_bits[0]))
    init_s = time.perf_counter() - t0 - wall_s
    if bits != MOQ_SCHEDULE:
        raise AssertionError(f"MoQ bits {bits} != {MOQ_SCHEDULE}")
    if per_step != [1] * (warmup + steps) or len(leaves) != 146:
        raise AssertionError(f"quantize launches a step {per_step} (1 "
                             f"expected), {len(leaves)} leaves (146 "
                             f"expected)")
    expect = {"quantize": steps,
              **{name: cfg.n_layer * steps for name in FLASH_KERNELS}}
    if launches != expect or plain_calls:
        raise AssertionError(f"train_moq launches {launches} != {expect}, "
                             f"plain calls {plain_calls}")
    named = dict(zip(engine.param_names, engine.master))
    distinct = {}
    for name in ("wte", "h.0.mlp.c_fc.kernel", "h.35.mlp.c_proj.kernel"):
        m = named[name]
        distinct[name] = max(int(torch.unique(g).numel())
                             for g in m.reshape(8, -1))
        if distinct[name] > 2 ** bits[-1]:
            raise AssertionError(f"{name}: a group holds {distinct[name]} "
                                 f"values at {bits[-1]} bits")
    _check_compute_copy(engine)
    b_ms = 8 * n_elems / HBM_BYTES_PER_S * 1e3
    step_s = wall_s / steps
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = (6 * cfg.num_params() + 12 * cfg.n_layer * TRAIN_SEQ
             * cfg.n_embd) * tokens
    emit({"phase": "train_moq", "model": "gpt2_large", "layers": cfg.n_layer,
          "layout": "unrolled", "quantize_training": MOQ,
          "moq_leaves": len(leaves), "moq_elements": n_elems,
          "steps": steps, "warmup_steps": warmup, "init_and_warmup_s": init_s,
          "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
          "model_tflop_per_s": flops / step_s / 1e12,
          "mfu": flops / step_s / BF16_FLOP_PER_S,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "boundary_device_ms": boundary_ms,
          "boundary_device_ms_median": statistics.median(boundary_ms),
          "boundary_bound_ms": b_ms,
          "boundary_pct_of_bound": 100.0 * b_ms
          / statistics.median(boundary_ms),
          "boundary_host_us": host_us,
          "boundary_host_us_median": statistics.median(host_us),
          "bits": bits, "quantize_launches_a_step": per_step,
          "plain_calls": plain_calls, "distinct_values_a_group": distinct,
          "launches": launches, "losses": losses})
    return engine, batch, launches


def train_moq_sr_phase(warmup=MOQ_SR_WARMUP, steps=MOQ_SR_STEPS):
    """The same model in the scan layout (JAX's default: the layer kernels
    are 3-D stacked leaves; MoQ quantizes wte, wpe and the 8 stacked [36,
    .] bias and LayerNorm leaves) with moq_sr_ds_config: asymmetric
    stochastic rounding, the blend falling 0.75 → 0, PLD; exactly one
    quantize launch a boundary (the 10 leaves, the stacked ones as their
    36 layer tensors, and the blend in one table), each boundary's device
    time against its bound and its host time."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    cfg = train_model_config()
    engine, _, _, _ = ds.initialize(config=moq_sr_ds_config(),
                                    model=GPT2LMHeadModel(cfg))
    batch = train_batch_ids()
    leaves, n_elems = moq_leaves(engine.module)
    ratios = []
    (losses, wall_s, launches, per_step, boundary_ms, host_us,
     plain_calls) = _run_moq(
        engine, batch, warmup, steps,
        lambda i: ratios.append(engine.quantizer.quantize_real_ratio))
    if ratios != MOQ_SR_RATIOS:
        raise AssertionError(f"blend ratios {ratios} != {MOQ_SR_RATIOS}")
    if per_step != [1] * (warmup + steps) or plain_calls:
        raise AssertionError(f"quantize launches a step {per_step} for "
                             f"{len(leaves)} leaves (1 expected), plain "
                             f"calls {plain_calls}")
    _check_compute_copy(engine)
    step_s = wall_s / steps
    b_ms = 8 * n_elems / HBM_BYTES_PER_S * 1e3
    emit({"phase": "train_moq_sr", "model": "gpt2_large",
          "layers": cfg.n_layer, "layout": "scan",
          "quantize_training": moq_sr_ds_config()["quantize_training"],
          "progressive_layer_drop": PLD,
          "moq_leaves": ["/".join(p) for p, _, _ in leaves],
          "moq_elements": n_elems, "steps": steps, "warmup_steps": warmup,
          "step_ms": step_s * 1e3,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
          "boundary_device_ms": boundary_ms,
          "boundary_device_ms_median": statistics.median(boundary_ms),
          "boundary_bound_ms": b_ms,
          "boundary_pct_of_bound": 100.0 * b_ms
          / statistics.median(boundary_ms),
          "boundary_host_us": host_us,
          "boundary_host_us_median": statistics.median(host_us),
          "ratios": ratios,
          "quantize_launches_a_step": per_step, "launches": launches,
          "keep_prob_last": float(engine.progressive_layer_drop.theta_at(
              engine.global_step_t)),
          "losses": losses})
    return launches


# ------------------------------------------------------------ ZeRO-3, 4 ranks

def zero3_kernel_phase(gen):
    """The fused collective kernels in one process at the main path's
    shapes: M = 2048 tokens (a rank's 2 x 1024), each of GPT-2 large's four
    projections cut into 4 shards as stage 3 cuts it, the n = 4 "peers"
    local tensors. For each projection the forward all-gather+matmul and
    the transposed one of dx, every rank's output held against the plain
    version (bf16, and fp32 output at the timed rank; three reruns equal
    to the first bit for bit), and a planted fault (one chunk read from
    the wrong rank); mm_rs_partial (its fault: each
    chunk written into its neighbour's slot) and mm_rs_reduce (one peer's
    slot read from the wrong rank) held for every rank, and the reduced
    shards against one fp32 product over all ranks' tokens. The partials
    go where the ZeRO-3 backward puts them: into the columns of a layer's
    exchange region [n, run] (``parallel/overlap.py`` ReduceScatterBatch),
    beside the packed group's flat gradient; then one mm_rs_reduce launch
    reduces the layer (``zero3_layer_reduce``). Timed at rank
    ZERO3_TIMED_RANK by CUDA-graph replay; library: torch.matmul over the
    gathered W, and for mm_rs_partial torch.matmul of the same product
    (one torch.matmul over all four ranks' tokens, which gives every
    reduced shard at once, is printed beside it). Every main-path shape
    takes the TMA kernel (``*_route``); each ag_matmul and mm_rs_partial
    row also prints its tile walk (tile shape, tiles, grid, waves) and the
    mma.sync kernel's time on the same inputs (``mma_us``, held against
    the plain version at the timed rank), whose sums by name close the
    phase line."""
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    from deepspeed_tpu_torch.ops.cuda import tolerance
    from deepspeed_tpu_torch.parallel import overlap
    n, R = ZERO3_RANKS, ZERO3_TIMED_RANK
    M = TRAIN_BATCH * TRAIN_SEQ // n
    path = "train_zero3_fused"
    # the layer's exchange region, as the backward's batch lays it out:
    # the four streamed leaves, then the packed group
    sizes = [din * dout // n for _, din, dout, _ in ZERO3_LEAVES] + \
        [ZERO3_GROUP]
    offs = [overlap.batch_run(sizes[:i]) for i in range(len(sizes))]
    run = overlap.batch_run(sizes)
    regions = [torch.zeros(n, run, device="cuda") for _ in range(n)]
    ag_rep = "deepspeed_tpu/ops/pallas/fused_collective.py:299"
    rs_rep = "deepspeed_tpu/ops/pallas/fused_collective.py:491"
    results, mma_ms = [], {name: 0.0 for name in ZERO3_MMA_KERNELS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")) \
            .to(torch.bfloat16)

    def repeats(name, fn):
        """A kernel whose stage ring raced would give other bits on a
        rerun: three reruns must equal the first call bit for bit."""
        first = fn()
        if not all(torch.equal(first, fn()) for _ in range(3)):
            raise AssertionError(f"{name}: reruns differ from the first")

    def walk(plan, mma_name, ms, mma_err):
        mma_ms[mma_name] += ms
        return {"tile": [plan.bm, plan.bn, plan.bk], "tiles": plan.tiles,
                "grid": plan.grid, "waves": plan.waves, "mma_us": ms * 1e3,
                "mma_row_rel_err": mma_err}

    for (leaf, din, dout, d), off in zip(ZERO3_LEAVES, offs):
        W = rnd(din, dout, scale=0.02)
        shards = [t.contiguous() for t in W.chunk(n, dim=d)]
        wrong = list(shards)
        wrong[(R + 1) % n] = shards[(R + 2) % n]
        for transpose in (False, True):
            x = rnd(M, dout if transpose else din)
            K, N, ck, _, contract, b_col = k.ag_matmul_geometry(
                shards[0].shape, n, d, transpose)
            if k.ag_matmul_route(x, shards, d, transpose) != "ag_matmul":
                raise AssertionError(f"ag_matmul {leaf}: a main-path shape "
                                     f"left the TMA kernel")
            checks = []
            for r in range(n):
                got = k.ag_matmul(x, shards, r, d, transpose)
                want = k.ag_matmul_plain(x, shards, r, d, transpose)
                fault = k.ag_matmul_plain(x, wrong, r, d, transpose) \
                    if r == R else None
                checks.append(held("ag_matmul", got, want, fault))
            repeats("ag_matmul", lambda: k.ag_matmul(x, shards, R, d,
                                                     transpose))
            got = k.ag_matmul(x, shards, R, d, transpose, torch.float32)
            want = k.ag_matmul_plain(x, shards, R, d, transpose,
                                     torch.float32)
            fp32_err = tolerance.check_kernel("ag_matmul[fp32]", got, want)
            del got, want
            ms = time_graph_ms(lambda i: k.ag_matmul(x, shards, R, d,
                                                     transpose))
            call_ms = time_ms(lambda: k.ag_matmul(x, shards, R, d, transpose))
            plain_ms = time_ms(lambda: k.ag_matmul_plain(
                x, shards, R, d, transpose), reps=5, inner=1)
            w_full = W.t() if transpose else W
            lib_ms = time_graph_ms(lambda i: torch.matmul(x, w_full))
            mma_err = tolerance.check_kernel(
                "ag_matmul", k.ag_matmul_mma(x, shards, R, d, transpose),
                k.ag_matmul_plain(x, shards, R, d, transpose))
            mma = time_graph_ms(lambda i: k.ag_matmul_mma(x, shards, R, d,
                                                          transpose))
            plan = k.tile_plan("ag", M, K, N, ck, n, R, contract, sms=sms)
            record(results, "ag_matmul", path, ag_rep, checks, ms, call_ms,
                   plain_ms, bound(nbytes(x, W) + M * N * 2, 2 * M * K * N),
                   [{"leaf": leaf, "direction": "dx" if transpose else "y",
                     "M": M, "K": K, "N": N, "chunk": ck,
                     "contracting": contract, "transpose_w": transpose,
                     "shard": list(shards[0].shape), "ranks": n,
                     "fp32_out_row_rel_err": fp32_err,
                     **walk(plan, "ag_matmul_mma", mma, mma_err)}],
                   "one chunk read from the wrong rank", library_ms=lib_ms)
            del x
        # matmul+reduce-scatter: each rank its own tokens, its partials
        # into its region's columns for this leaf (slots a row apart)
        lhs = [rnd(M, din) for _ in range(n)]
        rhs = [rnd(M, dout, scale=0.02) for _ in range(n)]
        shard = din * dout // n
        cols = [reg[:, off:off + shard] for reg in regions]
        if k.mm_rs_partial_route(lhs[R], rhs[R], d, n, cols[R]) != \
                "mm_rs_partial":
            raise AssertionError(f"mm_rs_partial {leaf}: a main-path shape "
                                 f"left the TMA kernel")
        p_checks = []
        for r in range(n):
            k.mm_rs_partial(lhs[r], rhs[r], d, n, out=cols[r])
            want = k.mm_rs_partial_plain(lhs[r], rhs[r], d, n)
            fault = torch.roll(want, 1, dims=0) if r == R else None
            p_checks.append(held("mm_rs_partial", cols[r], want, fault))
            repeats("mm_rs_partial",
                    lambda: k.mm_rs_partial(lhs[r], rhs[r], d, n,
                                            out=cols[r]).clone())
        shape = (din // n, dout) if d == 0 else (din, dout // n)
        reduced = torch.cat([k.mm_rs_reduce_plain(cols, r).reshape(shape)
                             for r in range(n)], dim=d)
        l_all, r_all = torch.cat(lhs), torch.cat(rhs)
        dense = l_all.float().t() @ r_all.float()
        sum_err = tolerance.row_rel_err(reduced, dense)
        del reduced, dense
        out = cols[R]
        ms = time_graph_ms(lambda i: k.mm_rs_partial(lhs[R], rhs[R], d, n,
                                                     out=out))
        call_ms = time_ms(lambda: k.mm_rs_partial(lhs[R], rhs[R], d, n,
                                                  out=out))
        plain_ms = time_ms(lambda: k.mm_rs_partial_plain(lhs[R], rhs[R], d,
                                                         n), reps=5, inner=1)
        lib_ms = time_graph_ms(lambda i: torch.matmul(lhs[R].t(), rhs[R]))
        all_ms = time_graph_ms(lambda i: torch.matmul(l_all.t(), r_all),
                               n=8)
        mma_err = tolerance.check_kernel(
            "mm_rs_partial", k.mm_rs_partial_mma(lhs[R], rhs[R], d, n),
            k.mm_rs_partial_plain(lhs[R], rhs[R], d, n))
        mma_out = torch.empty(n, shard, device="cuda")
        mma = time_graph_ms(lambda i: k.mm_rs_partial_mma(lhs[R], rhs[R], d,
                                                          n, out=mma_out))
        plan = k.tile_plan("rs", M, din, dout, (din if d == 0 else dout) // n,
                           n, shard_dim=d, sms=sms, slot=run)
        case = {"leaf": leaf, "M": M, "K": din, "N": dout, "shard_dim": d,
                "ranks": n, "region_offset": off, "region_run": run,
                "reduced_vs_fp32_product_row_rel_err": sum_err,
                "all_ranks_matmul_us": all_ms * 1e3}
        record(results, "mm_rs_partial", path, rs_rep, p_checks, ms, call_ms,
               plain_ms, bound(nbytes(lhs[R], rhs[R]) + 4 * din * dout,
                               2 * M * din * dout),
               [dict(case, **walk(plan, "mm_rs_partial_mma", mma, mma_err))],
               "each chunk written into its neighbour's slot",
               library_ms=lib_ms)
        del lhs, rhs, mma_out, l_all, r_all
        torch.cuda.empty_cache()
    # the packed group's flat gradients into their columns
    for reg in regions:
        reg[:, offs[-1]:offs[-1] + ZERO3_GROUP].copy_(torch.randn(
            n, ZERO3_GROUP, generator=gen, device="cuda"))
    zero3_layer_reduce(results, regions, offs, sizes, run, rs_rep)
    del regions
    torch.cuda.empty_cache()
    emit({"phase": "zero3_kernels", "ranks": n, "M": M,
          "rows": len(results),
          "kernel_ms_by_name": {**{name: sum(r["ms"] for r in results
                                             if r["name"] == name)
                                   for name in ZERO3_KERNELS}, **mma_ms},
          "library_ms": sum(r["library_ms"] or 0.0 for r in results),
          "max_abs_err": max(r["max_abs_err"] for r in results)})
    return results


def zero3_layer_reduce(results, regions, offs, sizes, run, replaces):
    """mm_rs_reduce as the ZeRO-3 backward's batch runs it: one launch a
    layer over the n ranks' [n, run] exchange regions (``regions``, the
    "peers", in rank order), into each entry's output in its dtype (the
    four streamed leaves' dW bf16, the packed group fp32). Held for every
    rank bit for bit against mm_rs_reduce_plain cast to each output's
    dtype, one peer's region read from the wrong rank as the timed
    rank's fault; and in ring mode's layout (the packed group alone,
    every leaf in it: one fp32 entry over the same elements). Timed at
    ZERO3_TIMED_RANK by graph replay; library: torch.sum(x, 0) over the
    rank's n chunk rows gathered into one local [n, run] buffer (the same
    sums, perhaps in another order: a time only); bound: each element
    read from every peer once and written once in its dtype."""
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    n, R = ZERO3_RANKS, ZERO3_TIMED_RANK
    dtypes = [torch.bfloat16] * len(ZERO3_LEAVES) + [torch.float32]

    def table():
        return [(off, torch.empty(m, dtype=dt, device="cuda"))
                for off, m, dt in zip(offs, sizes, dtypes)]

    def flat(outs):
        return torch.cat([t.float() for _, t in outs])[None]
    checks = []
    for r in range(n):
        got = k.mm_rs_reduce(regions, r, outs=table())
        want = k.mm_rs_reduce_fill(k.mm_rs_reduce_plain(regions, r), table())
        fault = None
        if r == R:
            bad = list(regions)
            bad[(R + 1) % n] = regions[(R + 2) % n]
            fault = flat(k.mm_rs_reduce_fill(k.mm_rs_reduce_plain(bad, r),
                                             table()))
        checks.append(held("mm_rs_reduce", flat(got), flat(want), fault))
    total = offs[-1] + sizes[-1]
    ring = [(0, torch.empty(total, device="cuda"))]
    ring_want = k.mm_rs_reduce_fill(
        k.mm_rs_reduce_plain(regions, R),
        [(0, torch.empty(total, device="cuda"))])
    checks.append(held("mm_rs_reduce", flat(k.mm_rs_reduce(
        regions, R, outs=ring)), flat(ring_want)))
    outs = table()
    ms = time_graph_ms(lambda i: k.mm_rs_reduce(regions, R, outs=outs))
    call_ms = time_ms(lambda: k.mm_rs_reduce(regions, R, outs=outs))
    ring_ms = time_graph_ms(lambda i: k.mm_rs_reduce(regions, R, outs=ring))
    plain_ms = time_ms(lambda: k.mm_rs_reduce_fill(
        k.mm_rs_reduce_plain(regions, R), outs), reps=5, inner=1)
    x = torch.stack([regions[(R + 1 + j) % n][R] for j in range(n)])
    lib_ms = time_graph_ms(lambda i: torch.sum(x, 0))
    elems = sum(sizes)
    out_bytes = sum(m * torch.empty((), dtype=dt).element_size()
                    for m, dt in zip(sizes, dtypes))
    ring_bound = bound(4 * (n + 1) * total, (n - 1) * total,
                       FP32_FLOP_PER_S)[0]
    names = [leaf for leaf, *_ in ZERO3_LEAVES] + ["packed_group"]
    record(results, "mm_rs_reduce", "train_zero3_fused", replaces, checks,
           ms, call_ms, plain_ms,
           bound(4 * n * elems + out_bytes, (n - 1) * elems,
                 FP32_FLOP_PER_S),
           [{"layer": "gpt2_large", "ranks": n, "run": run,
             "entries": [{"leaf": name, "offset": off, "elements": m,
                          "dtype": str(dt).replace("torch.", "")}
                         for name, off, m, dt in zip(names, offs, sizes,
                                                     dtypes)],
             "held": "bit for bit, every rank"},
            {"layout": "ring: the packed group alone, one fp32 entry",
             "elements": total, "held": "bit for bit",
             "ring_us": ring_ms * 1e3, "ring_bound_us": ring_bound * 1e3,
             "ring_pct_of_bound": 100.0 * ring_bound / ring_ms}],
           "one peer's region read from the wrong rank", library_ms=lib_ms,
           extra={"launches_per_layer": 1,
                  "library": "torch.sum(x, 0) over the n chunk rows in one "
                             "local [n, run] buffer"})


def zero3_ds_config(mode):
    """The training cell's config at ZeRO stage 3 with the prefetch
    pipeline; the four projections stream (their shards are 0.8-3.1 MB,
    above the 64 KiB min_shard_bytes) under fused_matmul. The default
    persistence threshold (1e5) keeps the [36, 1280] biases and
    LayerNorms, and ln_f, replicated."""
    cfg = train_ds_config()
    cfg["zero_optimization"] = {"stage": 3, "stage3_prefetch": True,
                                "stage3_prefetch_gather": mode}
    return cfg


def zero3_grad_check(rank, world, n_layer=2):
    """One step's gradients of a 2-layer model of GPT-2 large's width over
    the ranks, through the kernels (backend auto) and through their plain
    versions (backend lax), and through the plain versions with one chunk
    read from the wrong rank; each leaf gathered whole and held row-
    relative at GRAD_RTOL (floor 1e-3, as the one-card grad check). Rank 0
    then holds the kernels' gradients against the same step of a one-rank
    engine on the same weights, which catches what the kernels and their
    plain versions share, with a planted fault: rank 1's shards not
    scaled by 1/n."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from deepspeed_tpu_torch.ops import fused_collective as fc
    from deepspeed_tpu_torch.ops.cuda import tolerance
    from deepspeed_tpu_torch.parallel import prefetch
    from deepspeed_tpu_torch.parallel.mesh import Mesh, MeshConfig, make_mesh
    mesh = make_mesh(MeshConfig(data=world))
    engine, _, _, _ = ds.initialize(
        config=zero3_ds_config("fused_matmul"), mesh=mesh,
        model=GPT2LMHeadModel(train_model_config(n_layer)))
    batch = train_batch_ids()
    fn = engine._zero3_grads
    cfg = engine._fused_cfg

    def grads():
        g, loss, _ = fn(batch)
        full = {k: prefetch.gather_leaf(t, engine._entries[k], mesh)
                for k, t in zip(engine.param_names, g)}
        return float(loss), full
    loss_k, got = grads()
    engine._fused_cfg = dataclasses.replace(cfg, backend="lax")
    loss_p, want = grads()
    right = fc.peer_shards

    def wrong_chunk(w_shard, m):
        views = list(right(w_shard, m))
        views[(m.rank + 1) % m.size] = views[(m.rank + 2) % m.size]
        return views
    fc.peer_shards = wrong_chunk
    try:
        loss_f, fault = grads()
    finally:
        fc.peer_shards = right
    err = {k: tolerance.row_rel_err(got[k], want[k], floor=1e-3)
           for k in want}
    f_err = {k: tolerance.row_rel_err(fault[k], want[k], floor=1e-3)
             for k in want}
    weights = engine.gather_master()
    one = {}
    if rank == 0:
        single, _, _, _ = ds.initialize(
            config=train_ds_config(), model_parameters=weights,
            model=GPT2LMHeadModel(train_model_config(n_layer)),
            mesh=Mesh(1, 0, mesh.device), device=mesh.device)
        loss_1, g1 = model_loss_and_grads(single.module,
                                          batch["input_ids"])
        g1 = dict(zip(single.param_names, g1))
        scaled = {}
        for k, g in got.items():
            e = engine._entries[k]
            scaled[k] = g
            if e is not None:
                scaled[k] = g.clone()
                scaled[k].narrow(e[0], e[1], e[1]).mul_(world)
        e1 = {k: tolerance.row_rel_err(got[k], g1[k], floor=1e-3)
              for k in g1}
        s1 = {k: tolerance.row_rel_err(scaled[k], g1[k], floor=1e-3)
              for k in g1}
        w1, sw = max(e1, key=e1.get), max(s1, key=s1.get)
        one = {"one_card_loss": loss_1,
               "vs_one_card_max_row_rel_err": e1[w1],
               "vs_one_card_worst_leaf": w1,
               "vs_one_card_median_row_rel_err":
                   float(np.median(list(e1.values()))),
               "scale_fault_max_row_rel_err": s1[sw],
               "scale_fault_worst_leaf": sw}
        del single, g1, scaled
    engine.close()
    worst, f_worst = max(err, key=err.get), max(f_err, key=f_err.get)
    return {"layers": n_layer, "leaves": len(err), "loss_kernels": loss_k,
            "loss_plain": loss_p, "fault_loss": loss_f,
            "max_row_rel_err": err[worst], "worst_leaf": worst,
            "median_row_rel_err": float(np.median(list(err.values()))),
            "fault_max_row_rel_err": f_err[f_worst],
            "fault_worst_leaf": f_worst,
            "fault_leaves_rejected": sum(e > GRAD_RTOL
                                         for e in f_err.values()), **one}


def own_slot_only(reduce):
    """``mm_rs_reduce`` with a planted fault: each rank sums its own
    region n times, so a layer's dW holds its own tokens alone."""
    def faulty(views, rank, **kw):
        return reduce([views[rank]] * len(views), rank, **kw)
    return faulty


def zero3_train(mode, world, n_layer, warmup, steps, fault=False):
    """``initialize(mesh=...)`` of GPT-2 large and warmup + steps
    ``train_batch`` on one rank of the world; what the rank saw. With
    ``fault``, every mm_rs_reduce runs ``own_slot_only``."""
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    right = k.mm_rs_reduce
    if fault:
        k.mm_rs_reduce = own_slot_only(right)
    try:
        return _zero3_train(mode, world, n_layer, warmup, steps)
    finally:
        k.mm_rs_reduce = right


def _zero3_train(mode, world, n_layer, warmup, steps):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    mesh = make_mesh(MeshConfig(data=world))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _, _, _ = ds.initialize(config=zero3_ds_config(mode), mesh=mesh,
                                    model=GPT2LMHeadModel(
                                        train_model_config(n_layer)))
    batch = train_batch_ids()
    warm = [engine.train_batch(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    builder.launches.clear()             # count the main path's run only
    barriers, blocked_s = mesh.barriers, mesh.barrier_s
    t0 = time.perf_counter()
    losses = [engine.train_batch(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(builder.launches)
    blocked_s = mesh.barrier_s - blocked_s
    barriers = mesh.barriers - barriers
    t1 = time.perf_counter()
    for _ in range(50):                  # barriers with nothing queued
        mesh.barrier()
    idle_barrier_ms = (time.perf_counter() - t1) / 50 * 1e3
    lp, stats = engine._lp, engine.prefetch_live_param_stats()
    gathered = set(lp.sharded_ids)
    streamed = [engine._layer_leaves[i] for i in lp.fused]
    out = {"losses": [float(x) for x in torch.stack(warm + losses).cpu()],
           "init_and_warmup_s": init_s, "step_ms": wall_s / steps * 1e3,
           "barriers_per_step": barriers / steps,
           "barrier_wall_ms_per_step": blocked_s / steps * 1e3,
           "idle_barrier_ms": idle_barrier_ms,
           "launches": launches,
           "peak_torch_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "heap_gb": getattr(mesh.heap, "nbytes", 0) / 1e9,
           "streamed_leaves": streamed,
           "streamed_leaves_gathered": [engine._layer_leaves[i]
                                        for i in lp.fused if i in gathered],
           "live_param_stats": stats}
    engine.close()
    del engine
    torch.cuda.empty_cache()
    return out


def zero3_rank(rank, world, n_layer, warmup, steps):
    """One rank of the ZeRO-3 phases: the 2-layer grad check, then the
    fused_matmul and ring runs, then fused_matmul with own_slot_only."""
    out = {"grad_check": zero3_grad_check(rank, world)}
    for mode in ("fused_matmul", "ring"):
        out[mode] = zero3_train(mode, world, n_layer, warmup, steps)
    out["fault"] = zero3_train("fused_matmul", world, n_layer, warmup, steps,
                               fault=True)
    return out


def zero3_train_phase(n_layer=36, warmup=ZERO3_WARMUP, steps=ZERO3_STEPS):
    """Four ranks on the one card (processes started by ``spawn``, joined
    over gloo, their shards in each other's symmetric heaps): the 2-layer
    grad check, then GPT-2 large trained under fused_matmul, under ring,
    and under fused_matmul with a planted fault (``own_slot_only``).
    Prints every reading, then checks the launches a step a rank against
    the design (3 all-gather+matmuls a projection a layer: forward,
    recomputed forward, dx; one matmul+reduce-scatter each; the flash
    kernels as on one card, the forward twice), that no streamed leaf
    rides the packed gather, losses finite and falling, fused_matmul's
    and ring's losses within ZERO3_LOSS_RTOL of each other and of the
    one-card train phase's, and the fault's beyond it. Returns rank 0's
    fused run's launches."""
    from deepspeed_tpu_torch.parallel.mesh import spawn
    if not TRAIN_LOSSES:
        raise AssertionError("the ZeRO-3 runs are held to the train "
                             "phase's losses: run it first")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ranks = spawn(zero3_rank, ZERO3_RANKS, n_layer, warmup, steps,
                  timeout=900.0)
    g = ranks[0]["grad_check"]
    emit({"phase": "zero3_grad_check", "ranks": ZERO3_RANKS,
          "limit": GRAD_RTOL, "loss_limit": LOSS_RTOL,
          "fault": "the plain versions with one chunk read from the wrong "
                   "rank",
          "scale_fault": "rank 1's shard gradients not scaled by 1/n",
          **g})
    # a step a rank: the forward and its recomputation run the flash
    # forward and three all-gather+matmuls a projection, the backward its
    # delta and dq/dk/dv kernels and one matmul+reduce-scatter partial a
    # projection, each layer; one mm_rs_reduce a layer reduces the layer's
    # batch in both modes
    per_layer = 4 * n_layer
    flash = {"flash_attention_fwd": 2 * n_layer * steps,
             "flash_attention_bwd": n_layer * steps,
             "flash_attention_bwd_delta": n_layer * steps,
             "mm_rs_reduce": n_layer * steps}
    expect = {"ag_matmul": 3 * per_layer * steps,
              "mm_rs_partial": per_layer * steps,
              **{name: 0 for name in ZERO3_MMA_KERNELS}, **flash}
    want = {"fused_matmul": expect,
            "ring": {k: (v if k in flash else 0) for k, v in expect.items()}}
    runs = {m: ranks[0][m] for m in ("fused_matmul", "ring", "fault")}

    def max_rel(losses, ref):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    vs_ring = max_rel(runs["fused_matmul"]["losses"], runs["ring"]["losses"])
    one_card = {m: max_rel(run["losses"], TRAIN_LOSSES)
                for m, run in runs.items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for mode in ("fused_matmul", "ring"):
        run = runs[mode]
        emit({"phase": "train_zero3_fused" if mode == "fused_matmul"
              else "train_zero3_ring", "model": "gpt2_large",
              "layers": n_layer, "ranks": ZERO3_RANKS,
              "gather": mode, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "rows_per_rank": TRAIN_BATCH // ZERO3_RANKS,
              "warmup_steps": warmup, "steps": steps,
              "step_ms": run["step_ms"],
              "step_ms_by_rank": [rk[mode]["step_ms"] for rk in ranks],
              "tokens_per_s": tokens / run["step_ms"] * 1e3,
              "init_and_warmup_s": run["init_and_warmup_s"],
              "barriers_per_step": run["barriers_per_step"],
              "barrier_wall_ms_per_step": run["barrier_wall_ms_per_step"],
              "idle_barrier_ms": run["idle_barrier_ms"],
              "peak_torch_memory_gb_by_rank":
                  [rk[mode]["peak_torch_memory_gb"] for rk in ranks],
              "heap_gb_by_rank": [rk[mode]["heap_gb"] for rk in ranks],
              "launches_per_step_per_rank":
                  {k: v / steps for k, v in run["launches"].items()},
              "launches_predicted_per_step_per_rank":
                  {k: v / steps for k, v in want[mode].items()},
              "streamed_leaves": run["streamed_leaves"],
              "live_param_stats": run["live_param_stats"],
              "losses": run["losses"],
              "losses_vs_ring_max_rel": vs_ring if mode == "fused_matmul"
              else None,
              "losses_vs_one_card_max_rel": one_card[mode],
              "one_card_losses": TRAIN_LOSSES[:len(run["losses"])],
              "loss_rtol": ZERO3_LOSS_RTOL,
              "fault": "fused_matmul with each rank's mm_rs_reduce summing "
                       "its own region alone" if mode == "fused_matmul"
              else None,
              "fault_losses": runs["fault"]["losses"]
              if mode == "fused_matmul" else None,
              "fault_vs_one_card_max_rel": one_card["fault"]
              if mode == "fused_matmul" else None,
              "note": "four ranks time-share one card and read their "
                      "peers' shards from its own HBM: no multi-GPU "
                      "number"})

    if not g["max_row_rel_err"] <= GRAD_RTOL:
        raise AssertionError(f"zero3 grad check: {g['worst_leaf']} "
                             f"{g['max_row_rel_err']:.3g} > {GRAD_RTOL}")
    if not abs(g["loss_kernels"] - g["loss_plain"]) <= \
            LOSS_RTOL * abs(g["loss_plain"]):
        raise AssertionError(f"zero3 grad check: losses {g['loss_kernels']}"
                             f" vs {g['loss_plain']}")
    if not g["fault_max_row_rel_err"] > GRAD_RTOL:
        raise AssertionError("zero3 grad check: a planted fault passes")
    if not g["vs_one_card_max_row_rel_err"] <= GRAD_RTOL:
        raise AssertionError(f"zero3 grad check vs one card: "
                             f"{g['vs_one_card_worst_leaf']} "
                             f"{g['vs_one_card_max_row_rel_err']:.3g}")
    if not abs(g["loss_kernels"] - g["one_card_loss"]) <= \
            LOSS_RTOL * abs(g["one_card_loss"]):
        raise AssertionError(f"zero3 grad check: loss {g['loss_kernels']} "
                             f"vs one card's {g['one_card_loss']}")
    if not g["scale_fault_max_row_rel_err"] > GRAD_RTOL:
        raise AssertionError("zero3 grad check: the unscaled shard passes")
    for r, rank in enumerate(ranks):
        for mode in ("fused_matmul", "ring"):
            run = rank[mode]
            got = {k: run["launches"].get(k, 0) for k in
                   set(expect) | set(run["launches"])}
            if got != want[mode]:
                raise AssertionError(f"rank {r} {mode}: launches {got} != "
                                     f"{want[mode]}")
            if run["streamed_leaves_gathered"]:
                raise AssertionError(f"rank {r}: streamed leaves gathered "
                                     f"{run['streamed_leaves_gathered']}")
            if run["losses"] != ranks[0][mode]["losses"]:
                raise AssertionError(f"rank {r} {mode}: losses differ")
    for mode in ("fused_matmul", "ring"):
        losses = runs[mode]["losses"]
        timed = losses[warmup:]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{mode}: non-finite loss {losses}")
        if not timed[-1] < timed[0]:
            raise AssertionError(f"{mode}: the loss did not fall {timed}")
        if not one_card[mode] <= ZERO3_LOSS_RTOL:
            raise AssertionError(f"{mode}'s losses {losses} vs one card's "
                                 f"{TRAIN_LOSSES}")
    if not vs_ring <= ZERO3_LOSS_RTOL:
        raise AssertionError(f"fused_matmul vs ring losses: {vs_ring:.3g}")
    # one barrier a layer in the backward, in both modes: the modes'
    # exchanges differ only inside the layer batches
    for r, rank in enumerate(ranks):
        if rank["fused_matmul"]["barriers_per_step"] != \
                rank["ring"]["barriers_per_step"]:
            raise AssertionError(
                f"rank {r}: fused_matmul takes "
                f"{rank['fused_matmul']['barriers_per_step']} barriers a "
                f"step, ring {rank['ring']['barriers_per_step']}")
    if not one_card["fault"] > ZERO3_LOSS_RTOL:
        raise AssertionError(f"a planted fault passes the loss check: "
                             f"{one_card['fault']:.3g}")
    ZERO3_RING_LOSSES[:] = runs["ring"]["losses"]
    return runs["fused_matmul"]["launches"]


def zero2_kernel_phase(gen):
    """mm_rs_reduce as the bucket stream of ZeRO stages 0-2 runs it on
    the card: one launch a bucket over the n ranks' [n, padded / n] fp32
    regions, row ``rank`` of each summed into the rank's chunk. At the
    first and the last bucket of GPT-2 large's default plan (the engine's
    ``plan_buckets`` over the model's leaves in order, ZERO2_BUCKET,
    ZERO3_RANKS ranks), the four "peers" local tensors in this process:
    every rank's chunk held bit for bit against mm_rs_reduce_plain, one
    peer's region read from the wrong rank as the timed rank's fault.
    Timed at ZERO3_TIMED_RANK by graph replay; library: torch.sum(x, 0)
    over the rank's n rows in one [n, run] buffer; bound: n·run·4 bytes
    read and run·4 written at 3.35 TB/s. The row is the first (larger)
    bucket's; the last bucket's numbers are its second case."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    from deepspeed_tpu_torch.parallel import overlap
    n, R = ZERO3_RANKS, ZERO3_TIMED_RANK
    shapes = [p.shape for p in
              GPT2LMHeadModel(train_model_config()).parameters()]
    buckets = overlap.plan_buckets(shapes, ZERO2_BUCKET, n)
    checks, cases, timed = [], [], []
    for which, b in (("first", buckets[0]), ("last", buckets[-1])):
        run = b.padded // n
        regions = [torch.randn(n, run, generator=gen, device="cuda")
                   for _ in range(n)]
        for r in range(n):
            got = k.mm_rs_reduce(regions, r)
            want = k.mm_rs_reduce_plain(regions, r)
            fault = None
            if r == R:
                bad = list(regions)
                bad[(R + 1) % n] = regions[(R + 2) % n]
                fault = k.mm_rs_reduce_plain(bad, r)[None]
            checks.append(held("mm_rs_reduce", got[None], want[None], fault))
            del got, want, fault
        out = torch.empty(run, device="cuda")
        ms = time_graph_ms(lambda i: k.mm_rs_reduce(regions, R, out=out),
                           n=8)
        call_ms = time_ms(lambda: k.mm_rs_reduce(regions, R, out=out),
                          reps=10, inner=3)
        plain_ms = time_ms(lambda: k.mm_rs_reduce_plain(regions, R),
                           reps=5, inner=1)
        x = torch.stack([regions[(R + 1 + j) % n][R] for j in range(n)])
        lib_ms = time_graph_ms(lambda i: torch.sum(x, 0), n=8)
        bnd = bound(4 * (n + 1) * run, (n - 1) * run, FP32_FLOP_PER_S)
        timed.append((ms, call_ms, plain_ms, lib_ms, bnd))
        cases.append({"bucket": which, "leaves": len(b.leaf_ids),
                      "elements": b.numel, "padded": b.padded, "run": run,
                      "ranks": n, "kernel_us": ms * 1e3,
                      "call_us": call_ms * 1e3, "plain_us": plain_ms * 1e3,
                      "library_us": lib_ms * 1e3, "bound_us": bnd[0] * 1e3,
                      "pct_of_bound": 100.0 * bnd[0] / ms,
                      "held": "bit for bit, every rank"})
        del regions, x, out
        torch.cuda.empty_cache()
    results = []
    ms, call_ms, plain_ms, lib_ms, bnd = timed[0]
    record(results, "mm_rs_reduce", "train_zero2",
           "deepspeed_tpu/ops/pallas/fused_collective.py:491", checks, ms,
           call_ms, plain_ms, bnd, cases,
           "one peer's region read from the wrong rank", library_ms=lib_ms,
           extra={"launches_per_bucket": 1, "buckets": len(buckets),
                  "library": "torch.sum(x, 0) over the n chunk rows in one "
                             "local [n, run] buffer"})
    emit({"phase": "zero2_kernels", "ranks": n, "bucket_elems": ZERO2_BUCKET,
          "buckets": [{"leaves": len(b.leaf_ids), "elements": b.numel,
                       "padded": b.padded} for b in buckets],
          "max_abs_err": max(c[0] for c in checks)})
    return results


def zero2_ds_config(stage=2):
    """The training cell's config at ZeRO stage 2 (or ``stage``) with
    overlap_comm and the default bucket."""
    cfg = train_ds_config()
    cfg["zero_optimization"] = {"stage": stage, "overlap_comm": True,
                                "reduce_bucket_size": ZERO2_BUCKET}
    return cfg


def _zero2_engine(n_layer, mesh, stage=2):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    engine, _, _, _ = ds.initialize(config=zero2_ds_config(stage), mesh=mesh,
                                    model=GPT2LMHeadModel(
                                        train_model_config(n_layer)))
    return engine


def zero2_train(rank, world, n_layer, warmup, steps, ckpt_dir=None,
                fault=False, stage=2):
    """One rank of ``train_zero2``: ``initialize(mesh=...)`` of GPT-2
    large at ZeRO ``stage`` (2), warmup + steps ``train_batch`` (the
    launches and the plain reduce's calls counted over the timed steps,
    each step's CUDA-event split read after them); with ``ckpt_dir`` then
    ``zero2_restore``'s rank: save, the uninterrupted next step, and a
    fresh engine loading the save and taking the same step. With
    ``fault`` every mm_rs_reduce runs ``own_slot_only``."""
    from deepspeed_tpu_torch.ops.cuda import builder
    from deepspeed_tpu_torch.ops.cuda import fused_collective as k
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    mesh = make_mesh(MeshConfig(data=world))
    right, right_plain = k.mm_rs_reduce, k.mm_rs_reduce_plain
    plain_calls = [0]

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return right_plain(*a, **kw)
    k.mm_rs_reduce_plain = counted_plain
    if fault:
        k.mm_rs_reduce = own_slot_only(right)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = _zero2_engine(n_layer, mesh, stage)
        batch = train_batch_ids()
        warm = [engine.train_batch(batch) for _ in range(warmup)]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        builder.launches.clear()          # count the main path's run only
        plain_calls[0] = 0
        barriers, blocked_s = mesh.barriers, mesh.barrier_s
        marks, losses = [], []
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(engine.train_batch(batch))
            marks.append(engine.world_marks)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, plain = dict(builder.launches), plain_calls[0]
        split = {name: statistics.median(
            m[i][0].elapsed_time(m[i + 1][0]) for m in marks)
            for i, name in enumerate(("exchange_ms", "update_ms",
                                      "gather_ms"))}
        out = {"losses": [float(x) for x in torch.stack(warm + losses).cpu()],
               "init_and_warmup_s": init_s, "step_ms": wall_s / steps * 1e3,
               "split_ms": split,
               "barriers_per_step": (mesh.barriers - barriers) / steps,
               "barrier_wall_ms_per_step":
                   (mesh.barrier_s - blocked_s) / steps * 1e3,
               "buckets_per_step": len(engine._buckets),
               "launches": launches, "plain_reduce_calls": plain,
               "peak_torch_memory_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "heap_gb": mesh.heap.nbytes / 1e9,
               "moment_slices": sum(e is not None for e in engine._plan),
               "leaves": len(engine._plan)}
        if ckpt_dir is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.save_checkpoint(ckpt_dir, tag="zero2")
            out["save_s"] = time.perf_counter() - t0
            out["next_loss"] = float(engine.train_batch(batch))
            engine.close()
            del engine
            torch.cuda.empty_cache()
            fresh = _zero2_engine(n_layer, mesh)
            t0 = time.perf_counter()
            fresh.load_checkpoint(ckpt_dir, tag="zero2")
            torch.cuda.synchronize()
            out["load_s"] = time.perf_counter() - t0
            out["resumed_loss"] = float(fresh.train_batch(batch))
            engine = fresh
        engine.close()
        del engine
        torch.cuda.empty_cache()
        return out
    finally:
        k.mm_rs_reduce, k.mm_rs_reduce_plain = right, right_plain


def zero2_rank(rank, world, n_layer, warmup, steps, ckpt_dir):
    """One rank of the stage-2 phases: the run with its save and resume,
    the run with the planted fault, and the same steps at stage 1."""
    return {"run": zero2_train(rank, world, n_layer, warmup, steps,
                               ckpt_dir),
            "fault": zero2_train(rank, world, n_layer, warmup, steps,
                                 fault=True),
            "stage1": zero2_train(rank, world, n_layer, warmup, steps,
                                  stage=1)}


def zero2_train_phase(n_layer=36, warmup=ZERO3_WARMUP, steps=ZERO3_STEPS):
    """Four ranks on the one card at ZeRO stage 2 (``train_zero2``): every
    reading printed, then the launches a step a rank against the design
    (one mm_rs_reduce a bucket, no call of its plain version, the flash
    forward, delta and backward once a layer: remat is off), losses
    finite, falling, the same on every rank, within ZERO3_LOSS_RTOL of
    train_zero3_ring's and the one-card train phase's, the planted
    fault's beyond it. Then ``zero2_restore``: the four-rank save
    resumed by fresh four-rank engines, bit for bit, and by one rank in
    this process, within ZERO3_LOSS_RTOL. Stage 1 runs the same exchange
    and the same moment slices: its losses must equal stage 2's bit for
    bit. Returns rank 0's launches."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from deepspeed_tpu_torch.parallel.mesh import spawn
    if not (TRAIN_LOSSES and ZERO3_RING_LOSSES):
        raise AssertionError("train_zero2 is held to the train phase's and "
                             "train_zero3_ring's losses: run them first")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ckpt_dir = tempfile.mkdtemp(prefix="zero2_")
    try:
        ranks = spawn(zero2_rank, ZERO3_RANKS, n_layer, warmup, steps,
                      ckpt_dir, timeout=900.0)
        run, fault, stage1 = (ranks[0][k]
                              for k in ("run", "fault", "stage1"))
        cfg = train_model_config(n_layer)
        engine, _, _, _ = ds.initialize(config=zero2_ds_config(),
                                        model=GPT2LMHeadModel(cfg))
        t0 = time.perf_counter()
        engine.load_checkpoint(ckpt_dir, tag="zero2")
        torch.cuda.synchronize()
        one_load_s = time.perf_counter() - t0
        one_rank_loss = float(engine.train_batch(train_batch_ids()))
        del engine
        torch.cuda.empty_cache()
        ckpt_gb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                      os.walk(ckpt_dir) for f in fs) / 1e9
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    def max_rel(losses, ref):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    vs_one = max_rel(run["losses"], TRAIN_LOSSES)
    vs_ring = max_rel(run["losses"], ZERO3_RING_LOSSES)
    fault_vs_one = max_rel(fault["losses"], TRAIN_LOSSES)
    buckets = run["buckets_per_step"]
    want = {"mm_rs_reduce": buckets * steps,
            **{name: n_layer * steps for name in FLASH_KERNELS}}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit({"phase": "train_zero2", "model": "gpt2_large", "layers": n_layer,
          "ranks": ZERO3_RANKS, "zero_stage": 2, "overlap_comm": True,
          "bucket_elems": ZERO2_BUCKET, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "rows_per_rank": TRAIN_BATCH // ZERO3_RANKS,
          "warmup_steps": warmup, "steps": steps,
          "step_ms": run["step_ms"],
          "step_ms_by_rank": [rk["run"]["step_ms"] for rk in ranks],
          "tokens_per_s": tokens / run["step_ms"] * 1e3,
          "split_ms": run["split_ms"],
          "split_ms_by_rank": [rk["run"]["split_ms"] for rk in ranks],
          "init_and_warmup_s": run["init_and_warmup_s"],
          "barriers_per_step": run["barriers_per_step"],
          "barrier_wall_ms_per_step": run["barrier_wall_ms_per_step"],
          "buckets_per_step": buckets,
          "moment_slices": run["moment_slices"], "leaves": run["leaves"],
          "peak_torch_memory_gb_by_rank":
              [rk["run"]["peak_torch_memory_gb"] for rk in ranks],
          "heap_gb_by_rank": [rk["run"]["heap_gb"] for rk in ranks],
          "launches_per_step_per_rank":
              {k: v / steps for k, v in run["launches"].items()},
          "launches_predicted_per_step_per_rank":
              {k: v / steps for k, v in want.items()},
          "plain_reduce_calls_by_rank":
              [rk["run"]["plain_reduce_calls"] for rk in ranks],
          "losses": run["losses"],
          "one_card_losses": TRAIN_LOSSES[:len(run["losses"])],
          "zero3_ring_losses": ZERO3_RING_LOSSES[:len(run["losses"])],
          "losses_vs_one_card_max_rel": vs_one,
          "losses_vs_zero3_ring_max_rel": vs_ring,
          "loss_rtol": ZERO3_LOSS_RTOL,
          "fault": "each rank's mm_rs_reduce summing its own region alone",
          "fault_losses": fault["losses"],
          "fault_vs_one_card_max_rel": fault_vs_one,
          "stage1_step_ms": stage1["step_ms"],
          "stage1_losses": stage1["losses"],
          "note": "four ranks time-share one card and read their peers' "
                  "regions from its own HBM: no multi-GPU number"})
    emit({"phase": "zero2_restore", "ranks": ZERO3_RANKS,
          "checkpoint_gb": ckpt_gb,
          "save_s_by_rank": [rk["run"]["save_s"] for rk in ranks],
          "load_s_by_rank": [rk["run"]["load_s"] for rk in ranks],
          "next_loss": run["next_loss"],
          "resumed_loss_by_rank": [rk["run"]["resumed_loss"]
                                   for rk in ranks],
          "one_rank_loss": one_rank_loss, "one_rank_load_s": one_load_s,
          "one_rank_rel": abs(one_rank_loss - run["next_loss"])
          / abs(run["next_loss"]), "loss_rtol": ZERO3_LOSS_RTOL})

    for r, rank in enumerate(ranks):
        got = {k: rank["run"]["launches"].get(k, 0) for k in
               set(want) | set(rank["run"]["launches"])}
        if got != want:
            raise AssertionError(f"train_zero2 rank {r}: launches {got} != "
                                 f"{want}")
        if rank["run"]["plain_reduce_calls"]:
            raise AssertionError(f"train_zero2 rank {r}: the plain reduce "
                                 f"ran {rank['run']['plain_reduce_calls']} "
                                 f"times")
        if rank["run"]["losses"] != run["losses"]:
            raise AssertionError(f"train_zero2 rank {r}: losses differ")
        if rank["run"]["resumed_loss"] != run["next_loss"]:
            raise AssertionError(
                f"zero2_restore rank {r}: resumed loss "
                f"{rank['run']['resumed_loss']!r} != the uninterrupted "
                f"{run['next_loss']!r}")
    if stage1["losses"] != run["losses"] or stage1["launches"] != want:
        raise AssertionError(f"train_zero2 at stage 1: losses "
                             f"{stage1['losses']} (stage 2's "
                             f"{run['losses']}), launches "
                             f"{stage1['launches']}")
    losses, timed = run["losses"], run["losses"][warmup:]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_zero2: non-finite loss {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"train_zero2: the loss did not fall {timed}")
    if not vs_one <= ZERO3_LOSS_RTOL:
        raise AssertionError(f"train_zero2 losses {losses} vs one card's "
                             f"{TRAIN_LOSSES}: {vs_one:.3g}")
    if not vs_ring <= ZERO3_LOSS_RTOL:
        raise AssertionError(f"train_zero2 losses {losses} vs "
                             f"train_zero3_ring's {ZERO3_RING_LOSSES}: "
                             f"{vs_ring:.3g}")
    if not fault_vs_one > ZERO3_LOSS_RTOL:
        raise AssertionError(f"train_zero2: a planted fault passes the loss "
                             f"check: {fault_vs_one:.3g}")
    if not abs(one_rank_loss - run["next_loss"]) <= \
            ZERO3_LOSS_RTOL * abs(run["next_loss"]):
        raise AssertionError(f"zero2_restore: one rank's loss "
                             f"{one_rank_loss} vs {run['next_loss']}")
    return run["launches"]


def llama_int8_init(cfg):
    """The int8 engine: seed-0 bf16 weights at LLAMA_INIT_STD quantized to
    int8 codes when ``build_engine`` runs (quantize_bits 8), and the int8
    pool (kv_cache_bits 8)."""
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.models.llama_inference import \
        init_serving_params
    params = init_serving_params(cfg, seed=0, device="cuda",
                                 std=LLAMA_INIT_STD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = serving.build_engine("llama", cfg, params,
                               config={"serving": SERVING_INT8})
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    p = eng.adapter.p
    emit({"phase": "llama_int8_init", "model": "llama_7b",
          "params": cfg.num_params(), "init_std": LLAMA_INIT_STD,
          "quantize_s": quant_s,
          "weight_gb": sum(nbytes(t) for t in p.values()) / 1e9,
          "int8_layer_weight_gb": sum(nbytes(t) for t in p.values()
                                      if t.dtype == torch.int8) / 1e9,
          "pool_gb": nbytes(*eng.cache.pool) / 1e9,
          "pool_blocks": eng.cache.num_blocks,
          "fused_proj": eng.adapter.fused_proj()})
    return eng


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.models.gpt2 import gpt2_large, init_params
    from deepspeed_tpu_torch.models.llama import llama_7b
    from deepspeed_tpu_torch.models.llama_inference import \
        init_serving_params
    profile = "--profile" in sys.argv[1:]
    smi, rates = phase_device()
    cfg = gpt2_large(dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    eng = serving.build_engine(
        "gpt2", cfg, init_params(cfg, seed=0, device="cuda"),
        config={"serving": SERVING})
    kernels = kernel_phase(eng, cfg, gen)
    launches = {"serve": serve_phase(eng, cfg, "gpt2")}
    if profile:
        profile_phase(eng, cfg, "gpt2_large")
    del eng                       # free each serving engine before the next
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels_g, launches_g = gpt2_generate(gen, profile)
    kernels += kernels_g
    launches.update(launches_g)
    eng = serving.build_engine(
        "gpt2", cfg, init_params(cfg, seed=0, device="cuda"),
        config={"serving": SERVING_INT8})
    emit({"phase": "gpt2_int8_init", "model": "gpt2_large",
          "int8_layer_weight_gb": sum(nbytes(t) for t in eng.adapter.p.values()
                                      if t.dtype == torch.int8) / 1e9,
          "weight_gb": sum(nbytes(t) for t in eng.adapter.p.values()) / 1e9,
          "pool_gb": nbytes(*eng.cache.pool) / 1e9,
          "pool_blocks": eng.cache.num_blocks})
    kernels += kernel_phase(eng, cfg, gen)
    launches["serve_gpt2_int8"] = serve_phase(eng, cfg, "gpt2_int8")
    if profile:
        profile_phase(eng, cfg, "gpt2_large_int8")
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lcfg = llama_7b()
    eng = serving.build_engine(
        "llama", lcfg, init_serving_params(lcfg, seed=0, device="cuda",
                                           std=LLAMA_INIT_STD),
        config={"serving": SERVING})
    emit({"phase": "llama_init", "model": "llama_7b",
          "params": lcfg.num_params(), "init_std": LLAMA_INIT_STD,
          "weight_gb": sum(nbytes(t) for t in eng.adapter.p.values()) / 1e9,
          "pool_gb": nbytes(*eng.cache.pool) / 1e9,
          "pool_blocks": eng.cache.num_blocks,
          "fused_proj": eng.adapter.fused_proj()})
    kernels += llama_kernel_phase(eng, lcfg, gen)
    launches["serve_llama"] = serve_phase(eng, lcfg, "llama")
    if profile:
        profile_phase(eng, lcfg, "llama_7b")
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    eng = llama_int8_init(lcfg)
    kernels += llama_kernel_phase(eng, lcfg, gen)
    launches["serve_llama_int8"] = serve_phase(eng, lcfg, "llama_int8")
    if profile:
        profile_phase(eng, lcfg, "llama_7b_int8")
    kernels += generate_kernel_rows(eng, lcfg, gen)
    launches.update(generate_phase(eng, lcfg, profile))
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels += train_kernel_phase(gen)
    engine, batch, train_launches = train_phase()
    if profile:
        train_profile_phase(engine, batch)
    del engine, batch
    torch.cuda.empty_cache()
    grad_check_phase()
    launches["train"] = train_launches
    torch.cuda.empty_cache()
    kernels += flash_rows(gen, LLAMA_BATCH, "train_llama", H=32, S=LLAMA_SEQ,
                          D=128)
    engine, batch, launches["train_llama"] = train_llama_phase()
    llama_generate_phase(engine.module, "trained")
    if profile:
        train_profile_phase(engine, batch, phase="train_llama_profile")
    del engine, batch
    torch.cuda.empty_cache()
    llama_generate_phase(llama_init_model(llama_train_config()), "init")
    torch.cuda.empty_cache()
    llama_grad_check_phase()
    torch.cuda.empty_cache()
    launches["train_llama_offload"] = train_llama_offload_phase(rates)
    launches["train_llama_offload_host"] = train_llama_offload_phase(
        rates, stream="host")
    offload_parity_phase()
    train_nvme_phase()
    kernels += flash_rows(gen, INF_BATCH, "train_infinity", H=INF_HEADS,
                          S=INF_SEQ, D=INF_E // INF_HEADS)
    launches["train_infinity"] = infinity_phases(rates)
    kernels += bert_kernel_phase(gen)
    engine, batch, launches["train_bert_sparse"] = train_bert_sparse_phase()
    if profile:
        train_profile_phase(engine, batch, phase="train_bert_sparse_profile")
    del engine, batch
    torch.cuda.empty_cache()
    bert_grad_check_phase()
    torch.cuda.empty_cache()
    kernels += quantize_kernel_phase(gen)
    engine, batch, launches["train_moq"] = train_moq_phase()
    if profile:
        train_profile_phase(engine, batch, phase="train_moq_profile")
    del engine, batch
    torch.cuda.empty_cache()
    launches["train_moq_sr"] = train_moq_sr_phase()
    torch.cuda.empty_cache()
    kernels += zero3_kernel_phase(gen)
    kernels += flash_rows(gen, TRAIN_BATCH // ZERO3_RANKS,
                          "train_zero3_fused")
    launches["train_zero3_fused"] = zero3_train_phase()
    torch.cuda.empty_cache()
    kernels += zero2_kernel_phase(gen)
    # the flash kernels on the stage-2 path run at train_zero3_fused's
    # shapes (B 2 a rank, H 20, S 1024, D 64): the rows held and timed
    # there are this path's too
    kernels += [dict(row, path="train_zero2") for row in kernels
                if row["path"] == "train_zero3_fused"
                and row["name"] in FLASH_KERNELS]
    launches["train_zero2"] = zero2_train_phase()
    decode_paths = [p_ for p_ in launches if p_.startswith(("serve",
                                                            "generate"))]
    for p_ in decode_paths:
        if launches[p_].get("kv_quant_int8", 0):
            raise AssertionError(f"kv_quant_int8 launched on the {p_} path: "
                                 f"the attention call appends the rows")
    emit({"phase": "kv_quant_int8_launches",
          "by_path": {p_: launches[p_].get("kv_quant_int8", 0)
                      for p_ in decode_paths}})
    for row in kernels:
        if row["path"] is None:      # matvec_int8, kv_quant_int8: no model
            continue                 # path launches them
        row["launches"] = launches[row["path"]].get(row["name"], 0)
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
