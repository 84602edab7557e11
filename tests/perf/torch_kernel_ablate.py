"""Where a redesigned kernel's time goes: the flash forward and
matvec_stacked rebuilt with parts switched off, timed beside the kernel
as it is, on one card.

    python3 tests/perf/torch_kernel_ablate.py

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


def build(src_name, patches, variants, tmp):
    """{variant: the library's C entry} for each variant of one source."""
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
        path = os.path.join(tmp, f"{name}_{src_name}")
        with open(path, "w") as f:
            f.write(src)
        lib = path + ".so"
        procs[name] = (lib, subprocess.Popen(
            [builder._nvcc(), *builder.NVCC_FLAGS, "-shared", "-I",
             builder.CSRC, "-o", lib, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    entries = {}
    entry = ("dstpu_flash_fwd" if src_name == "flash_attention.cu"
             else "dstpu_matvec_stacked")
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

    with tempfile.TemporaryDirectory() as tmp:
        flash = build("flash_attention.cu", FLASH_PATCHES, FLASH_VARIANTS,
                      tmp)
        mv = build("decode.cu", MV_PATCHES, MV_VARIANTS, tmp)
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
        L, B, E = 32, 8, 4096
        x = torch.randn(B, E, generator=gen, device="cuda").to(torch.bfloat16)
        s = torch.rand(L, generator=gen, device="cuda") * 0.01 + 0.002
        lids = [torch.tensor(i, dtype=torch.int32, device="cuda")
                for i in range(L)]
        out = torch.empty(B, E, dtype=torch.bfloat16, device="cuda")
        for kind in ("bf16", "int8"):
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
