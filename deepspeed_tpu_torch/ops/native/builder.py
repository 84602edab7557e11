"""Build and load the port's host C++ libraries.

The port's counterpart of ``deepspeed_tpu/ops/native/builder.py:25-118``:
each host op (``csrc/cpu_adam.cpp``, the SIMD Adam; ``csrc/aio.cpp``, the
async I/O handle) is one plain C++ source compiled by ``g++ -O3 -shared
-fPIC -std=c++17 -march=native -fopenmp`` into one shared library and
loaded with ``ctypes``. It builds at first use into
``csrc/build/native-<hash>/``, the hash covering the source, the
command and the host CPU, so an edited source rebuilds and an unchanged
one loads the cached library; the library is written under a temporary
name and renamed, so concurrent builders agree. A failed build raises: there is
no build without ``-march=native`` and no Python fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
         "-fopenmp"]

_lock = threading.Lock()
_cache = {}
# seconds each library took to build in this process (0.0: cached)
build_seconds = {}


def _cpu_flags():
    """The host CPU's model and instruction-set flags (/proc/cpuinfo), so
    that a library built with -march=native on one host is not loaded on
    another."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n")
    except OSError:
        return b""
    keep = [ln for ln in lines
            if ln.startswith((b"flags", b"model name", b"Features"))]
    return b"\n".join(sorted(set(keep)))


class OpBuilder:
    """One source → one ``lib<name>.so``; ``load()`` builds on first use
    and returns the ``ctypes.CDLL``."""

    def __init__(self, name, source, extra_flags=()):
        self.name = name
        self.source = os.path.join(CSRC, source)
        self.extra_flags = list(extra_flags)

    def command(self, out):
        return ["g++", *FLAGS, *self.extra_flags, self.source, "-o", out]

    def so_path(self):
        h = hashlib.sha256(" ".join(self.command("")).encode())
        with open(self.source, "rb") as f:
            h.update(f.read())
        h.update(_cpu_flags())     # -march=native code is the host's
        return os.path.join(CSRC, "build", f"native-{h.hexdigest()[:16]}",
                            f"lib{self.name}.so")

    def build(self):
        """Compile unless the library for this source and command exists;
        returns its path."""
        so = self.so_path()
        if os.path.exists(so):
            build_seconds.setdefault(self.name, 0.0)
            return so
        if shutil.which("g++") is None:
            raise RuntimeError(f"g++ not found: the host library {self.name} "
                               f"of deepspeed_tpu_torch cannot be built")
        os.makedirs(os.path.dirname(so), exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=os.path.dirname(so)) as tmp:
            out = os.path.join(tmp, os.path.basename(so))
            done = subprocess.run(self.command(out), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"failed to build {self.name}:\n"
                                   f"{done.stdout}")
            os.replace(out, so)
        build_seconds[self.name] = time.perf_counter() - t0
        return so

    def load(self):
        with _lock:
            if self.name not in _cache:
                _cache[self.name] = ctypes.CDLL(self.build())
            return _cache[self.name]


class CPUAdamBuilder(OpBuilder):
    def __init__(self):
        super().__init__("cpu_adam", "cpu_adam.cpp")


class AsyncIOBuilder(OpBuilder):
    def __init__(self):
        super().__init__("aio", "aio.cpp", extra_flags=["-pthread"])
