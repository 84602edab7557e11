"""ctypes binding of the async I/O library (``csrc/aio.cpp``).

The port's counterpart of ``deepspeed_tpu/ops/native/aio.py:54-497``
over contiguous CPU tensors where the JAX package passes numpy arrays:
``AsyncIOHandle`` (io_uring through raw syscalls, or a thread pool, with
``async_pread``/``async_pwrite`` + ``wait`` and ``sync_pread``/
``sync_pwrite``), ``AlignedArena``, and the O_DIRECT mode with its probe
and its process-wide latch.

O_DIRECT mode (``o_direct=True``): swap files open with ``O_DIRECT``
and every submission to such a file goes through an alignment layer.
Buffers that are page-aligned with page-aligned lengths submit
zero-copy; an aligned body with an unaligned tail submits the body
zero-copy and the tail through a one-page bounce buffer from a pooled
``AlignedArena``; an unaligned buffer bounces whole. Direct submissions
are cut here at ``block_size`` so that the C splitter, whose pieces do
not keep alignment, always sees one piece. A filesystem that refuses
O_DIRECT (tmpfs, overlayfs: EINVAL at open or at a probe write) latches
the whole process to buffered I/O once, with one warning: the run keeps
its semantics and reports ``direct_active`` false. Files written under
O_DIRECT have page-rounded sizes: the exact lengths live in the
swapper's metadata and readers ask for the rounded length.
"""

import ctypes
import errno
import fcntl
import logging
import mmap
import os
import threading

import torch

from deepspeed_tpu_torch.ops.native.builder import AsyncIOBuilder

logger = logging.getLogger("deepspeed_tpu_torch")

_lib = None

ALIGNMENT = mmap.PAGESIZE


def load():
    """Build (at first use) and load the library, its argtypes set."""
    global _lib
    if _lib is None:
        lib = AsyncIOBuilder().load()
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.aio_handle_create2.restype = P
        lib.aio_handle_create2.argtypes = [I64, I, I, I, I, I]
        lib.aio_handle_backend.argtypes = [P]
        lib.aio_handle_backend.restype = I
        lib.aio_handle_destroy.argtypes = [P]
        lib.aio_handle_destroy.restype = None
        lib.aio_open.argtypes = [ctypes.c_char_p, I]
        lib.aio_open.restype = I
        lib.aio_close.argtypes = [I]
        lib.aio_close.restype = None
        for fn in (lib.aio_pread, lib.aio_pwrite):
            fn.argtypes = [P, I, P, I64, I64]
            fn.restype = None
        for fn in (lib.aio_sync_pread, lib.aio_sync_pwrite):
            fn.argtypes = [P, I, P, I64, I64]
            fn.restype = I64
        lib.aio_handle_wait.argtypes = [P]
        lib.aio_handle_wait.restype = I64
        lib.aio_handle_errors.argtypes = [P]
        lib.aio_handle_errors.restype = I64
        _lib = lib
    return _lib


def align_up(n, alignment=ALIGNMENT):
    return -(-int(n) // alignment) * alignment


def aligned_empty(nbytes, alignment=ALIGNMENT):
    """A page-aligned uint8 CPU tensor of exactly ``nbytes`` over an
    anonymous mmap (page-aligned by construction; the tensor keeps the
    mapping alive)."""
    mm = mmap.mmap(-1, max(align_up(nbytes, alignment), alignment))
    return torch.frombuffer(mm, dtype=torch.uint8)[:nbytes]


def nbytes_of(t):
    return t.numel() * t.element_size()


def as_bytes(t):
    """The bytes of a contiguous CPU tensor as a flat uint8 view."""
    if not (t.device.type == "cpu" and t.is_contiguous()):
        raise ValueError("aio buffers are contiguous CPU tensors")
    return t.reshape(-1).view(torch.uint8)


class _Lease:
    """One pooled aligned buffer, checked out of an AlignedArena."""

    __slots__ = ("arena", "mm", "cap", "view")

    def __init__(self, arena, mm, cap):
        self.arena = arena
        self.mm = mm
        self.cap = cap
        self.view = torch.frombuffer(mm, dtype=torch.uint8)

    def release(self):
        if self.arena is not None:
            self.view = None
            self.arena._give(self.mm, self.cap)
            self.arena = None
            self.mm = None


class AlignedArena:
    """Pooled page-aligned bounce buffers for O_DIRECT submissions,
    bucketed by aligned capacity (the swap tier's sizes repeat every
    step, so after one cycle a lease is a free-list pop). Thread-safe."""

    def __init__(self, alignment=ALIGNMENT):
        self.alignment = alignment
        self._free = {}
        self._lock = threading.Lock()

    def lease(self, nbytes):
        cap = max(align_up(nbytes, self.alignment), self.alignment)
        with self._lock:
            bucket = self._free.get(cap)
            if bucket:
                mm = bucket.pop()
            else:
                mm = mmap.mmap(-1, cap)
        return _Lease(self, mm, cap)

    def _give(self, mm, cap):
        with self._lock:
            self._free.setdefault(cap, []).append(mm)


_ARENA = AlignedArena()

# the buffered-I/O latch: one for the process, since a filesystem that
# refuses O_DIRECT refuses it to every handle
_FALLBACK = {"latched": False, "warned": False}
_DIR_PROBE = {}
_FALLBACK_ERRNOS = (errno.EINVAL, errno.ENOTSUP,
                    getattr(errno, "EOPNOTSUPP", errno.ENOTSUP))


def o_direct_fallback_latched():
    return _FALLBACK["latched"]


def reset_o_direct_fallback_for_tests():
    """Clear the latch and the probe cache (tests switch filesystems in
    one process)."""
    _FALLBACK["latched"] = False
    _FALLBACK["warned"] = False
    _DIR_PROBE.clear()


def _latch_fallback(path, err):
    _FALLBACK["latched"] = True
    if not _FALLBACK["warned"]:
        _FALLBACK["warned"] = True
        logger.warning(
            "O_DIRECT unsupported on %s (%s): the aio tier runs BUFFERED "
            "I/O for the rest of this process; its read and write rates "
            "are page-cache-assisted from here on", path, err)


def _probe_o_direct(directory):
    """One direct write to a scratch file in ``directory`` (some
    filesystems take the open flag and refuse the first aligned write).
    Errors other than the refusal errnos report True: the real open
    raises them."""
    d = os.path.abspath(directory)
    cached = _DIR_PROBE.get(d)
    if cached is not None:
        return cached
    probe = os.path.join(d, f".o_direct_probe.{os.getpid()}")
    ok, fd = True, None
    lease = _ARENA.lease(ALIGNMENT)
    try:
        fd = os.open(probe, os.O_WRONLY | os.O_CREAT | os.O_TRUNC
                     | os.O_DIRECT, 0o644)
        os.pwrite(fd, lease.mm, 0)
    except OSError as e:
        if e.errno in _FALLBACK_ERRNOS:
            ok = False
    finally:
        lease.release()
        if fd is not None:
            os.close(fd)
        try:
            os.unlink(probe)
        except FileNotFoundError:
            pass
    _DIR_PROBE[d] = ok
    return ok


def fd_is_direct(fd):
    """Whether ``fd`` was opened with O_DIRECT (F_GETFL)."""
    try:
        return bool(fcntl.fcntl(fd, fcntl.F_GETFL) & os.O_DIRECT)
    except OSError:
        return False


class AsyncIOHandle:
    """The aio handle: ``block_size`` / ``queue_depth`` /
    ``single_submit`` / ``overlap_events`` / ``thread_count`` as the
    ``aio`` config block names them, ``async_pread``/``async_pwrite`` +
    ``wait``, the sync calls, and the O_DIRECT layer (module docstring).
    ``backend``: "auto" (io_uring where the kernel and its seccomp
    profile allow it, else the thread pool), "threads" or "io_uring"
    (raises where unsupported). ``wait`` raises on any failed request of
    the batch, once."""

    def __init__(self, block_size=1048576, queue_depth=8, single_submit=False,
                 overlap_events=True, thread_count=1, backend="auto",
                 o_direct=False):
        self.lib = load()
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.single_submit = single_submit
        self.overlap_events = overlap_events
        self.thread_count = thread_count
        self.o_direct = bool(o_direct)
        self.alignment = ALIGNMENT
        self._chunk = max(align_up(block_size), ALIGNMENT)
        self._arena = _ARENA
        self._pending = []       # (kind, dst view, lease, nbytes)
        self._keep = []          # buffers the library may still touch
        self.stats = {"direct_zero_copy": 0, "direct_bounced": 0,
                      "direct_tail_bounced": 0}
        codes = {"auto": 0, "threads": 1, "io_uring": 2}
        if backend not in codes:
            raise ValueError(f"backend must be one of {sorted(codes)}, "
                             f"got {backend!r}")
        self._h = self.lib.aio_handle_create2(
            block_size, queue_depth, thread_count, int(single_submit),
            int(overlap_events), codes[backend])
        if not self._h:
            raise OSError("io_uring backend requested but unsupported by "
                          "this kernel or its seccomp profile")

    @property
    def backend(self):
        return "io_uring" if self.lib.aio_handle_backend(self._h) \
            else "threads"

    @property
    def direct_active(self):
        """O_DIRECT asked for and not latched to buffered I/O."""
        return self.o_direct and not _FALLBACK["latched"]

    def io_nbytes(self, nbytes):
        """The transfer and file size for ``nbytes`` of data: page-rounded
        under active O_DIRECT, exact otherwise."""
        return align_up(nbytes) if self.direct_active else int(nbytes)

    def close_handle(self):
        if getattr(self, "_h", None):
            self.lib.aio_handle_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close_handle()

    # -- files -----------------------------------------------------------
    def open(self, path, for_write):
        if self.direct_active:
            flags = (os.O_WRONLY | os.O_CREAT | os.O_TRUNC) if for_write \
                else os.O_RDONLY
            fd = self._open_direct(path, flags)
            if fd is not None:
                return fd
        fd = self.lib.aio_open(str(path).encode(), int(for_write))
        if fd < 0:
            raise OSError(f"aio_open failed for {path}")
        return fd

    def open_fd(self, path, flags, mode=0o644):
        """``os.open`` with the handle's direct mode (and its latch)
        applied, for the swappers' own flags."""
        if self.direct_active:
            fd = self._open_direct(path, flags, mode)
            if fd is not None:
                return fd
        return os.open(path, flags, mode)

    def _open_direct(self, path, flags, mode=0o644):
        """The O_DIRECT open, or None once latched to buffered I/O."""
        directory = os.path.dirname(os.path.abspath(str(path))) or "."
        if not _probe_o_direct(directory):
            _latch_fallback(path, "probe write refused")
            return None
        try:
            return os.open(str(path), flags | os.O_DIRECT, mode)
        except OSError as e:
            if e.errno in _FALLBACK_ERRNOS:
                _latch_fallback(path, e)
                return None
            raise

    def close(self, fd):
        self.lib.aio_close(fd)

    # -- asynchronous requests -------------------------------------------
    def async_pread(self, buf, fd, offset=0):
        if self.o_direct and fd_is_direct(fd):
            return self._direct_submit(buf, fd, offset, write=False)
        b = as_bytes(buf)
        self._keep.append(b)
        self.lib.aio_pread(self._h, fd, b.data_ptr(), b.numel(), offset)

    def async_pwrite(self, buf, fd, offset=0):
        if self.o_direct and fd_is_direct(fd):
            return self._direct_submit(buf, fd, offset, write=True)
        b = as_bytes(buf)
        self._keep.append(b)
        self.lib.aio_pwrite(self._h, fd, b.data_ptr(), b.numel(), offset)

    def wait(self):
        """Wait for every request submitted so far; raise if any failed."""
        done = self.lib.aio_handle_wait(self._h)
        self._keep = []
        try:
            self._raise_errors()
        finally:
            self._drain_pending(failed=False)
        return done

    # -- the O_DIRECT layer ----------------------------------------------
    def _direct_submit(self, buf, fd, offset, write):
        if offset % self.alignment:
            raise ValueError(f"O_DIRECT offsets must be {self.alignment}-"
                             f"aligned, got {offset}")
        flat = as_bytes(buf)
        n = flat.numel()
        if n == 0:
            return
        a = self.alignment
        body = (n // a) * a if flat.data_ptr() % a == 0 else 0
        tail = n - body
        if body:
            self._submit_chunks(flat[:body], fd, offset, write)
            if tail == 0:
                self.stats["direct_zero_copy"] += 1
        if tail:
            # the unaligned rest rides a pooled bounce buffer as one
            # aligned transfer (zero-padded when written)
            bounce = align_up(tail)
            lease = self._arena.lease(bounce)
            if write:
                lease.view[:tail] = flat[body:]
                lease.view[tail:bounce] = 0
                self._pending.append(("w", None, lease, 0))
            else:
                self._pending.append(("r", flat[body:], lease, tail))
            self._submit_chunks(lease.view[:bounce], fd, offset + body,
                                write)
            self.stats["direct_tail_bounced" if body
                       else "direct_bounced"] += 1

    def _submit_chunks(self, view, fd, offset, write):
        submit = self.lib.aio_pwrite if write else self.lib.aio_pread
        n = view.numel()
        self._keep.append(view)
        for off in range(0, n, self._chunk):
            size = min(self._chunk, n - off)
            submit(self._h, fd, view.data_ptr() + off, size, offset + off)

    def _drain_pending(self, failed):
        for kind, dst, lease, n in self._pending:
            try:
                if kind == "r" and not failed:
                    dst.copy_(lease.view[:n])
            finally:
                lease.release()
        self._pending = []

    def _raise_errors(self):
        # aio_handle_errors returns and clears: a failure is reported once,
        # to the wait that saw it
        n = self.lib.aio_handle_errors(self._h)
        if n:
            self._drain_pending(failed=True)
            raise IOError(f"{n} async IO request(s) failed")

    # -- synchronous requests --------------------------------------------
    def sync_pread(self, buf, path_or_fd, offset=0):
        return self._sync(buf, path_or_fd, offset, write=False)

    def sync_pwrite(self, buf, path_or_fd, offset=0):
        return self._sync(buf, path_or_fd, offset, write=True)

    def _sync(self, buf, path_or_fd, offset, write):
        fd, opened = (path_or_fd, False) if isinstance(path_or_fd, int) \
            else (self.open(path_or_fd, write), True)
        try:
            if self.o_direct and fd_is_direct(fd):
                # the C sync calls bypass the alignment layer
                self._direct_submit(buf, fd, offset, write)
                self.wait()
                return nbytes_of(buf)
            b = as_bytes(buf)
            fn = self.lib.aio_sync_pwrite if write else self.lib.aio_sync_pread
            done = fn(self._h, fd, b.data_ptr(), b.numel(), offset)
            self._raise_errors()
            return done
        finally:
            if opened:
                self.close(fd)


def make_handle(aio_config=None, backend="auto"):
    """A handle with the ``aio`` config block's knobs (None: defaults)."""
    cfg = aio_config
    return AsyncIOHandle(
        block_size=getattr(cfg, "block_size", 1 << 20),
        queue_depth=getattr(cfg, "queue_depth", 8),
        single_submit=getattr(cfg, "single_submit", False),
        overlap_events=getattr(cfg, "overlap_events", True),
        thread_count=getattr(cfg, "thread_count", 2),
        backend=backend,
        o_direct=getattr(cfg, "o_direct", False))

