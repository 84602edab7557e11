"""Build and load the port's CUDA kernels.

The port's counterpart of ``deepspeed_tpu/ops/native/builder.py`` (which
builds the host C++ libraries): every ``csrc/*.cu`` source is compiled by
``nvcc`` for ``sm_90a`` with a plain C interface, one ``nvcc`` per source
started together, then linked into one shared library under
``csrc/build/<hash>/`` and loaded with ``ctypes``. The hash covers the
sources, the headers they share (``csrc/*.cuh``) and the flags, so an
edited source rebuilds and an unchanged one loads the cached library. A failed build raises; nothing falls back.

``launches`` counts kernel launches by wrapper name: each wrapper adds
one where it launches its kernel, and nowhere else.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
LIB_NAME = "libdstpu_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]

launches = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point (all return cudaError_t as int)
SIGNATURES = {
    "dstpu_flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    "dstpu_flash_bwd_dkv": [_P] * 8 + [_I, _I, _F, _I, _P],
    "dstpu_flash_bwd_dq": [_P] * 7 + [_I, _I, _F, _I, _P],
    "dstpu_ln_qkv_stacked": [_P] * 8 + [_I] * 5 + [_F, _P],
    "dstpu_matvec_stacked": [_P] * 5 + [_I] * 4 + [_P],
    "dstpu_out_ffn_stacked": [_P] * 18 + [_I] * 4 + [_F, _P],
    "dstpu_matvec_int8": [_P] * 5 + [_I] * 4 + [_P],
    "dstpu_out_ffn_glu_stacked": [_P] * 11 + [_I] * 4 + [_F, _P],
    "dstpu_decode_attention": [_P] * 9 + [_I] * 9 + [_F, _P],
    "dstpu_kv_quant_int8": [_P] * 9 + [_I] * 8 + [_P],
    "dstpu_bs_fwd": [_P] * 7 + [_I] * 5 + [_F, _P],
    "dstpu_bs_bwd_dq": [_P] * 9 + [_I] * 5 + [_F, _P],
    "dstpu_bs_bwd_dkv": [_P] * 10 + [_I] * 5 + [_F, _P],
    "dstpu_quantize": [_P] * 4 + [_I] * 8 + [_F, _P],
    "dstpu_ag_matmul": [_P] * 3 + [_I] * 11 + [_P],
    "dstpu_mm_rs_partial": [_P] * 3 + [_I] * 6 + [_P],
    "dstpu_mm_rs_reduce": [_P, _P] + [_I] * 4 + [_P],
    "dstpu_gemm_tma": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P] + [_I] * 15
    + [_P],
    # the symmetric heap (parallel/symmetric_memory.py)
    "dstpu_heap_alloc": [_I, _I, _P],
    "dstpu_heap_free": [_I, _P],
    "dstpu_ipc_get_handle": [_P, _P, _I],
    "dstpu_ipc_open": [_I, _P, _P],
    "dstpu_ipc_close": [_I, _P],
}


class KernelLibrary:
    """The loaded shared library plus how it was obtained."""

    def __init__(self, path, build_s, built):
        self.path = path
        self.build_s = build_s      # seconds spent in nvcc (0 if cached)
        self.built = built
        self.lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name, *args):
        """Call a C entry point; raise on a nonzero cudaError_t."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(
                f"{name} failed with cudaError_t {err}: the launch was "
                f"refused or a previous kernel faulted")


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of deepspeed_tpu_torch cannot be built")


def headers():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cuh"))


def source_hash(srcs=None):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (srcs or sources()) + headers():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(verbose=False):
    """Compile (or find cached) and return the library's path and the
    seconds nvcc took (0.0 when the cached library was used)."""
    srcs = sources()
    out_dir = os.path.join(CSRC, "build", source_hash(srcs))
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path, 0.0
    os.makedirs(os.path.dirname(out_dir), exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out_dir)) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if verbose and out:
                print(out, flush=True)
            if p.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.makedirs(out_dir, exist_ok=True)
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builders agree
    return lib_path, time.perf_counter() - t0


_loaded = None


def kernels(verbose=False) -> KernelLibrary:
    """Build at first use, then return the loaded library."""
    global _loaded
    if _loaded is None:
        t0 = time.perf_counter()
        path, nvcc_s = build(verbose=verbose)
        _loaded = KernelLibrary(path, build_s=time.perf_counter() - t0,
                                built=nvcc_s > 0)
    return _loaded
