"""Where a redesigned kernel's time goes: the flash forward, the flash
backward and matvec_stacked rebuilt with parts switched off, timed beside
the kernel as it is, on one card.

    python3 tests/perf/torch_kernel_ablate.py [fwd] [bwd] [matvec]

(default: all three).

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
matvec_stacked (LLaMA-7B's o-projection, [8, 4096] x [32, 4096, 4096],
bf16 and int8 codes): ``no_epilogue`` (no cluster barrier, reduction or
store), ``no_loads``, and both. One JSON line a time, with the card's
name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

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
    "no_epilogue": [(
        "  cluster.sync();   // every block's partials are visible to the "
        "cluster\n",
        "  return;\n")],
    "no_loads": [(
        "        sm90::mbar_expect_tx(&full[s], C::STAGE);\n"
        "        sm90::tma_load_3d(st, &maps.w, n0, k, l, &full[s]);\n"
        "        sm90::tma_load_2d(st + MV_BOX, &maps.x, k, 0, &full[s]);\n",
        "        sm90::mbar_arrive(&full[s]);\n")],
}
MV_VARIANTS = {"kernel": [], "no_epilogue": ["no_epilogue"],
               "no_loads": ["no_loads"],
               "no_epilogue_no_loads": ["no_epilogue", "no_loads"]}


def build(src_name, patches, variants, tmp, entry):
    """{variant: the library's C entry ``entry``} for each variant of one
    source."""
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
        path = os.path.join(tmp, f"{entry}_{name}_{src_name}")
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
        fn = getattr(ctypes.CDLL(lib), entry)
        fn.argtypes = builder.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


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

    parts = sys.argv[1:] or ["fwd", "bwd", "matvec"]
    with tempfile.TemporaryDirectory() as tmp:
        flash = (build("flash_attention.cu", FLASH_PATCHES, FLASH_VARIANTS,
                       tmp, "dstpu_flash_fwd") if "fwd" in parts else {})
        bwd = (build("flash_attention.cu", BWD_PATCHES, BWD_VARIANTS, tmp,
                     "dstpu_flash_bwd") if "bwd" in parts else {})
        mv = (build("decode.cu", MV_PATCHES, MV_VARIANTS, tmp,
                    "dstpu_matvec_stacked") if "matvec" in parts else {})
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
        L, B, E = 32, 8, 4096
        x = torch.randn(B, E, generator=gen, device="cuda").to(torch.bfloat16)
        s = torch.rand(L, generator=gen, device="cuda") * 0.01 + 0.002
        lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
                for i in range(L)]
        out = torch.empty(B, E, dtype=torch.bfloat16, device="cuda")
        for kind in ("bf16", "int8") if mv else ():
            w = ((torch.randn(L, E, E, generator=gen, device="cuda") * 0.02)
                 .to(torch.bfloat16) if kind == "bf16" else
                 torch.randint(-127, 128, (L, E, E), generator=gen,
                               device="cuda", dtype=torch.int8))
            for name, fn in mv.items():
                def call(i, fn=fn):
                    err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                             lids[i].data_ptr(), out.data_ptr(), B, E, E, L,
                             int(kind == "int8"), 0, stream())
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")
                print(json.dumps({"kernel": f"matvec_stacked {kind}",
                                  "variant": name,
                                  "us": 1e3 * time_graph_ms(call, n=L),
                                  "card": card}), flush=True)
            del w


if __name__ == "__main__":
    main()
