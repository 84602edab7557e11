"""NVMe residency for optimizer state and parameters, over the aio library.

Port of ``deepspeed_tpu/runtime/swap_tensor/swapper.py`` on CPU tensors:
``TensorSwapper`` (named fp32 buffers, one file each, with a
double-buffered ``prefetch``), ``_StagingArena`` (staging buffers from one
``ContiguousMemoryAllocator``), ``PartitionedParamSwapper`` (the
ZeRO-Infinity parameter tier: compute-dtype leaves rest in one file each
and stream disk → staging → device around each step, with a sliding
read window, write-behind parking and its byte cache; ``swap_in_stream``
yields them on the host through the window alone) and
``OptimizerStateSwapper`` (Adam moments on NVMe: prefetch, fetch, store,
store-behind).

Layout: one file per (tensor, field) under ``<nvme_path>/<sub_dir>_<pid>/``.
Reads and writes never share an aio handle (``wait`` drains a whole
handle): write-behind has a handle of its own, and its drain fence runs
before any pending file is read back from disk. Write files are
preallocated and kept open without ``O_TRUNC``, so steady-state writes
reuse their extents. ``take_stall_s()`` returns the host seconds spent
blocked on the disk since its last call; byte counters go to the
``registry`` given (``swap/bytes_read``, ``swap/bytes_written``,
``swap/cache_hit_bytes``).

Metadata read back (``load_meta``) is checked against the files: each
file's size must be its leaf's ``shape × itemsize`` (page-rounded when
written under O_DIRECT), else it raises instead of restoring a truncated
or stale file.
"""

import json
import logging
import math
import os
import shutil
import time
import weakref

import torch

from deepspeed_tpu_torch.ops.native import aio as aio_lib
from deepspeed_tpu_torch.runtime.zero.contiguous_memory_allocator import \
    ContiguousMemoryAllocator
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry

logger = logging.getLogger("deepspeed_tpu_torch")

_DTYPES = {str(d).replace("torch.", ""): d for d in (
    torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int64,
    torch.int8, torch.uint8)}


def sweep_stale_pid_dirs(nvme_path, prefix):
    """Remove ``<prefix>_<pid>`` siblings whose process is gone (a killed
    process leaves its scratch behind); a live pid is left alone."""
    try:
        names = os.listdir(nvme_path)
    except OSError:
        return []
    swept = []
    for name in names:
        tail = name.rsplit("_", 1)[-1]
        if not name.startswith(prefix + "_") or not tail.isdigit() \
                or int(tail) == os.getpid():
            continue
        try:
            os.kill(int(tail), 0)
        except ProcessLookupError:
            shutil.rmtree(os.path.join(nvme_path, name), ignore_errors=True)
            swept.append(name)
        except OSError:
            continue
    if swept:
        logger.info("reclaimed %d stale swap scratch dir(s) under %s: %s",
                    len(swept), nvme_path, ", ".join(sorted(swept)))
    return swept


def _close_fds_and_rm(path, fds, remove):
    """weakref.finalize target (must not refer to the swapper); ``fds`` is
    the live dict, emptied by ``release``."""
    for fd in list(fds.values()):
        try:
            os.close(fd)
        except OSError:
            pass
    fds.clear()
    if remove:
        shutil.rmtree(path, ignore_errors=True)


def _preallocate(fd, nbytes):
    os.ftruncate(fd, nbytes)
    try:
        os.posix_fallocate(fd, 0, nbytes)
    except OSError:
        pass   # a filesystem without fallocate: sparse until written


class TensorSwapper:
    """Owns a swap directory and an aio handle; swaps named buffers."""

    def __init__(self, nvme_path, aio_config=None, sub_dir="zero_swap"):
        sweep_stale_pid_dirs(nvme_path, sub_dir)
        self.dir = os.path.join(nvme_path, f"{sub_dir}_{os.getpid()}")
        os.makedirs(self.dir, exist_ok=True)
        self.handle = aio_lib.make_handle(aio_config)
        self._pending_read = None     # (name, buffer, fd)
        self._finalizer = weakref.finalize(
            self, shutil.rmtree, self.dir, ignore_errors=True)

    def _path(self, name):
        return os.path.join(self.dir, f"{name}.swp")

    def _drain_pending(self):
        if self._pending_read is None:
            return None, None
        name, buf, fd = self._pending_read
        self._pending_read = None
        try:
            self.handle.wait()
        finally:
            self.handle.close(fd)
        return name, buf

    def swap_out(self, name, t):
        # a sync request must not share the handle with an in-flight
        # prefetch: it would take the prefetch's completion and errors
        self._drain_pending()
        self.handle.sync_pwrite(t.contiguous(), self._path(name))

    def swap_in(self, name, out):
        if self._pending_read and self._pending_read[0] == name:
            _, buf = self._drain_pending()
            if buf is not out:
                out.copy_(buf)
            return out
        self._drain_pending()
        self.handle.sync_pread(out, self._path(name))
        return out

    def prefetch(self, name, out):
        """Start the read of ``name``; the next ``swap_in(name)`` waits
        for it."""
        self._drain_pending()
        fd = self.handle.open(self._path(name), False)
        self.handle.async_pread(out, fd)
        self._pending_read = (name, out, fd)

    def release(self):
        try:
            self._drain_pending()
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


class _StagingArena:
    """fp32 staging buffers from one contiguous arena, sized to ``slots``
    of the largest leaf seen (grown whenever nothing is live, so that
    leaves of any size converge on an arena that fits them). Live
    buffers never move, as a read may be in flight into them; a request
    that cannot be placed gets a buffer of its own."""

    def __init__(self, slots=4, aligned=False):
        self.arena = None
        self._live = 0
        self._max_numel = 0
        self._slots = max(4, int(slots))
        self._aligned = bool(aligned)

    def _align_elems(self):
        return aio_lib.ALIGNMENT // 4 if self._aligned else 1

    def take(self, shape):
        """(tensor id or None, an fp32 tensor of ``shape``)."""
        numel = math.prod(shape)
        self._max_numel = max(self._max_numel, numel)
        ae = self._align_elems()
        slot = -(-self._max_numel // ae) * ae
        if self.arena is None or (self._live == 0
                                  and self.arena.size < self._slots * slot):
            self.arena = ContiguousMemoryAllocator(
                self._slots * slot, torch.float32, align_elems=ae)
        alloc = -(-numel // ae) * ae
        fits = self.arena._largest_free() >= alloc or self._live == 0
        if not fits or alloc > self.arena.total_free:
            if self._aligned:
                return None, aio_lib.aligned_empty(numel * 4).view(
                    torch.float32).view(shape)
            return None, torch.empty(shape, dtype=torch.float32)
        tid, view = self.arena.allocate_tensor(numel)
        self._live += 1
        return tid, view.view(shape)

    def give(self, tid):
        if tid is not None:
            self.arena.release_tensor(tid)
            self._live -= 1


class PartitionedParamSwapper:
    """NVMe-resident parameters (the ZeRO-Infinity parameter tier).
    Compute-dtype leaves rest in one file each; ``swap_in_device`` streams
    them disk → staging → device through a window of staging slots (the
    read of group k+1 overlaps the copies of group k), and
    ``swap_out_device`` writes them back. ``pipeline_write`` makes the
    park write-behind: the leaf is copied into a pool buffer, written on a
    handle of its own while the caller goes on, and the buffer stays as a
    byte cache of the file, so the next swap-in of that leaf is a host
    copy. ``drain_writes`` is the fence, run before any pending file is
    read back. Host memory for parameters stays at ``buffer_count`` read
    slots plus ``buffer_count`` write buffers of the largest leaf.

    ``durable`` (with a stable ``sub_dir``) keeps the files past the
    process, with a ``meta.json`` of the leaves' shapes and dtypes that
    ``load_meta`` reads back and checks against the files."""

    def __init__(self, nvme_path, aio_config=None, sub_dir=None,
                 durable=False, pipeline_read=False, pipeline_write=False,
                 buffer_count=2, registry=None, fsync=False):
        if sub_dir is None:
            sweep_stale_pid_dirs(nvme_path, "param_swap")
        self.dir = os.path.join(nvme_path,
                                sub_dir or f"param_swap_{os.getpid()}")
        os.makedirs(self.dir, exist_ok=True)
        self.handle = aio_lib.make_handle(aio_config)
        self._aio_config = aio_config
        self.meta = {}            # leaf -> (shape, dtype)
        self.pipeline_read = bool(pipeline_read)
        self.pipeline_write = bool(pipeline_write)
        self.buffer_count = max(2, int(buffer_count))
        self._staging = [None] * (self.buffer_count if pipeline_read else 2)
        self._durable = durable
        self._whandle = None
        self._wpool = []          # write buffers (uint8)
        self._wbusy = set()       # pool indices with a write in flight
        self._cache = {}          # leaf -> (pool index, nbytes)
        self._pending = set()     # leaves with an undrained write
        self._wfds = {}           # leaf -> preallocated write fd
        self._fsizes = {}
        self.fsync = bool(fsync)
        self._stall_s = 0.0
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._finalizer = weakref.finalize(
            self, _close_fds_and_rm, self.dir, self._wfds,
            remove=not durable)

    def _path(self, i):
        return os.path.join(self.dir, f"param_{i}.swp")

    def _meta_path(self):
        return os.path.join(self.dir, "meta.json")

    def save_meta(self):
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(i): [list(s), str(d).replace("torch.", "")]
                       for i, (s, d) in self.meta.items()}, f)
        os.replace(tmp, self._meta_path())

    def load_meta(self):
        """The leaves' metadata a previous process wrote, each file's
        size checked against it: a file whose size is neither its leaf's
        bytes nor their page-rounded size raises."""
        with open(self._meta_path()) as f:
            raw = json.load(f)
        meta = {int(i): (tuple(s), _DTYPES[d]) for i, (s, d) in raw.items()}
        for i in meta:
            want = self._leaf_nbytes(i, meta)
            try:
                got = os.path.getsize(self._path(i))
            except FileNotFoundError:
                raise ValueError(f"swap file of leaf {i} is missing: "
                                 f"{self._path(i)}") from None
            if got not in (want, aio_lib.align_up(want)):
                raise ValueError(
                    f"swap file {self._path(i)} holds {got} bytes; its "
                    f"metadata says {meta[i][0]} {meta[i][1]} = {want} "
                    f"bytes (truncated or stale)")
        self.meta = meta
        return meta

    def take_stall_s(self):
        """Host seconds blocked on the disk since the last call (sync
        requests and drain fences; I/O overlapped with other work is not
        counted)."""
        s, self._stall_s = self._stall_s, 0.0
        return s

    def _timed_wait(self, handle):
        t0 = time.perf_counter()
        try:
            handle.wait()
        finally:
            self._stall_s += time.perf_counter() - t0

    def _count(self, name, n):
        self.registry.counter(name).inc(n)

    def _write_fd(self, i, nbytes):
        """The cached write fd of leaf ``i``'s file, preallocated to its
        transfer size."""
        fd = self._wfds.get(i)
        if fd is None:
            fd = self.handle.open_fd(self._path(i), os.O_WRONLY | os.O_CREAT)
            self._wfds[i] = fd
        alloc = self.handle.io_nbytes(nbytes)
        if self._fsizes.get(i) != alloc:
            _preallocate(fd, alloc)
            if self.fsync and aio_lib.fd_is_direct(fd):
                os.fsync(fd)   # the size change is metadata
            self._fsizes[i] = alloc
        return fd

    def _readahead(self, indices):
        """fadvise(WILLNEED) the files about to be read, so that the first
        read of a file is not cold (no page cache under O_DIRECT)."""
        if self.handle.direct_active:
            return
        for i in indices:
            try:
                fd = os.open(self._path(i), os.O_RDONLY)
            except FileNotFoundError:
                continue
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_WILLNEED)
            finally:
                os.close(fd)

    @staticmethod
    def _host(leaf):
        """A contiguous CPU copy (or the tensor itself, already there)."""
        return leaf.detach().to("cpu").contiguous()

    def write_all(self, leaves):
        """Write every leaf (device or host) to its file, synchronously:
        the first park, or a re-park after a checkpoint load."""
        self.drain_writes()
        self._cache.clear()
        n = 0
        for i, leaf in enumerate(leaves):
            arr = self._host(leaf)
            self.meta[i] = (tuple(arr.shape), arr.dtype)
            b = aio_lib.as_bytes(arr)
            t0 = time.perf_counter()
            self.handle.sync_pwrite(b, self._write_fd(i, b.numel()))
            self._stall_s += time.perf_counter() - t0
            self._count("swap/bytes_written", b.numel())
            n = i + 1
        if self._durable:
            self.save_meta()
        self._readahead(range(n))

    def _take_wbuf(self, nbytes):
        """A pool buffer with no write in flight, preferring one that
        backs no cache entry; evicts the oldest idle cache entry when the
        pool is full, and drains the write handle when every buffer is
        busy."""
        alloc = self.handle.io_nbytes(nbytes)
        for _ in range(2):
            backing = {idx for idx, _ in self._cache.values()}
            free = [k for k in range(len(self._wpool))
                    if k not in self._wbusy and k not in backing]
            if not free and len(self._wpool) < self.buffer_count:
                self._wpool.append(aio_lib.aligned_empty(alloc))
                return len(self._wpool) - 1
            if not free:
                for leaf, (idx, _) in list(self._cache.items()):
                    if idx not in self._wbusy:
                        del self._cache[leaf]
                        free = [idx]
                        break
            if free:
                idx = free[0]
                if self._wpool[idx].numel() < alloc:
                    self._wpool[idx] = aio_lib.aligned_empty(alloc)
                return idx
            self.drain_writes()
        raise RuntimeError("write-behind pool exhausted after a drain")

    def _write_handle(self):
        if self._whandle is None:
            self._whandle = aio_lib.make_handle(self._aio_config)
        return self._whandle

    def write_behind(self, i, leaf):
        """Queue the write of leaf ``i`` (its bytes copied into a pool
        buffer: the caller may reuse ``leaf`` at once) and return."""
        if i in self._pending:
            self.drain_writes()     # two writes of one fd must not race
        src = aio_lib.as_bytes(self._host(leaf))
        n = src.numel()
        self.meta[i] = (tuple(leaf.shape), leaf.dtype)
        idx = self._take_wbuf(n)
        self._wpool[idx][:n].copy_(src)
        wlen = self.handle.io_nbytes(n)
        if wlen > n:
            self._wpool[idx][n:wlen] = 0
        self._write_handle().async_pwrite(self._wpool[idx][:wlen],
                                          self._write_fd(i, n))
        self._wbusy.add(idx)
        self._cache[i] = (idx, n)
        self._pending.add(i)
        self._count("swap/bytes_written", n)

    def drain_writes(self):
        """The fence: wait for every write-behind; with ``fsync`` the
        written files are made durable too."""
        if not self._pending and not self._wbusy:
            return
        self._timed_wait(self._write_handle())
        if self.fsync:
            t0 = time.perf_counter()
            direct = False
            for i in self._pending:
                fd = self._wfds.get(i)
                if fd is None:
                    continue
                if aio_lib.fd_is_direct(fd):
                    direct = True
                else:
                    os.fsync(fd)
            if direct:
                dfd = os.open(self.dir, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            self._stall_s += time.perf_counter() - t0
        self._wbusy.clear()
        self._pending.clear()

    @property
    def has_pending_writes(self):
        return bool(self._pending)

    def staged_leaf(self, i):
        """``(value, source)`` for parked leaf ``i``: a view of its
        write-behind cache buffer (``"cache"``; valid until the next
        park reuses the pool) or its file's path (``"file"``). Call
        ``drain_writes`` first while ``has_pending_writes``: a pending
        file is not whole yet."""
        c = self._cache.get(i)
        if c is not None:
            idx, nbytes = c
            return self._view(self._wpool[idx][:nbytes], i), "cache"
        return self._path(i), "file"

    def _stage(self, slot, nbytes):
        need = self.handle.io_nbytes(nbytes)
        buf = self._staging[slot]
        if buf is None or buf.numel() < need:
            self._staging[slot] = buf = aio_lib.aligned_empty(need)
        return buf[:need]

    def _leaf_nbytes(self, i, meta=None):
        shape, dtype = (meta or self.meta)[i]
        return math.prod(shape) * torch.empty((), dtype=dtype).element_size()

    def _view(self, raw, i):
        shape, dtype = self.meta[i]
        return raw[:self._leaf_nbytes(i)].view(dtype).view(shape)

    def swap_in_device(self, device, order=None):
        """Disk → ``device``: the list of leaves, read in ``order`` (a
        permutation of the leaves: the order compute consumes them).
        Leaves still in the write-behind cache are copied from it first
        (no fence: its bytes are what the file was written from); the
        rest read through the window of staging slots. Each leaf is
        copied out of its slot before the slot is read into again."""
        n = len(self.meta)
        outs = [None] * n
        if n == 0:
            return outs
        order = list(order) if order is not None else list(range(n))
        if sorted(order) != list(range(n)):
            raise ValueError(f"swap order is not a permutation: {order}")
        device = torch.device(device)

        def put(view):
            return view.clone() if device.type == "cpu" \
                else view.to(device)

        disk = [i for i in order if i not in self._cache]
        cached = [i for i in order if i in self._cache]
        self._readahead(disk)
        for i in cached:
            idx, nbytes = self._cache[i]
            outs[i] = put(self._view(self._wpool[idx][:nbytes], i))
            self._count("swap/cache_hit_bytes", nbytes)
        if self._pending.intersection(disk):
            self.drain_writes()
        slots = len(self._staging)
        group = max(1, slots // 2)
        groups = [disk[k:k + group] for k in range(0, len(disk), group)]
        fds = {}

        def submit(gi):
            for j, i in enumerate(groups[gi]):
                buf = self._stage((gi * group + j) % slots,
                                  self._leaf_nbytes(i))
                fds[i] = self.handle.open(self._path(i), False)
                self.handle.async_pread(buf, fds[i])

        if groups:
            submit(0)
        for gi, g in enumerate(groups):
            self._timed_wait(self.handle)
            for i in g:
                self.handle.close(fds.pop(i))
            if gi + 1 < len(groups):
                # group gi+1 takes the other half of the slots: its reads
                # overlap the copies below (a synchronous copy from
                # pageable memory has read its slot when it returns)
                submit(gi + 1)
            for j, i in enumerate(g):
                outs[i] = put(self._view(
                    self._staging[(gi * group + j) % slots], i))
                self._count("swap/bytes_read", self._leaf_nbytes(i))
        return outs

    def swap_in_stream(self, order=None):
        """The read schedule as a generator: ``(i, host view)`` in
        ``order`` (default: every leaf), through the same window of
        staging slots as ``swap_in_device`` and nothing else, so host
        memory stays at the window whatever the model's size. A view
        aliases its slot and is valid until the window moves past it:
        use or copy it before taking the next ``len(_staging) // 2``
        items. The whole window reads from disk (a pending write is
        drained first)."""
        n = len(self.meta)
        order = list(order) if order is not None else list(range(n))
        if not order:
            return
        if self._pending.intersection(order):
            self.drain_writes()
        self._readahead(order)
        slots = len(self._staging)
        group = max(1, slots // 2)
        groups = [order[k:k + group] for k in range(0, len(order), group)]
        fds = {}

        def submit(gi):
            for j, i in enumerate(groups[gi]):
                buf = self._stage((gi * group + j) % slots,
                                  self._leaf_nbytes(i))
                fds[i] = self.handle.open(self._path(i), False)
                self.handle.async_pread(buf, fds[i])

        submit(0)
        for gi, g in enumerate(groups):
            self._timed_wait(self.handle)
            for i in g:
                self.handle.close(fds.pop(i))
            if gi + 1 < len(groups):
                submit(gi + 1)     # the next group's reads overlap the use
            for j, i in enumerate(g):
                self._count("swap/bytes_read", self._leaf_nbytes(i))
                yield i, self._view(self._staging[(gi * group + j) % slots],
                                    i)

    def swap_out_device(self, leaves, write_behind=None):
        """Leaves (device or host) → disk: synchronous writes, or
        write-behind (``pipeline_write`` by default). Frees nothing."""
        wb = self.pipeline_write if write_behind is None else write_behind
        for i, leaf in enumerate(leaves):
            if wb:
                self.write_behind(i, leaf)
                continue
            if i in self._pending:
                self.drain_writes()
            arr = self._host(leaf)
            self.meta[i] = (tuple(arr.shape), arr.dtype)
            b = aio_lib.as_bytes(arr)
            t0 = time.perf_counter()
            fd = self._write_fd(i, b.numel())
            self.handle.sync_pwrite(b, fd)
            if self.fsync and not aio_lib.fd_is_direct(fd):
                os.fsync(fd)
            self._stall_s += time.perf_counter() - t0
            self._cache.pop(i, None)     # its staged bytes are stale
            self._count("swap/bytes_written", b.numel())
        if self._durable:
            self.save_meta()

    def release(self):
        try:
            self.drain_writes()
        finally:
            _close_fds_and_rm(self.dir, self._wfds, remove=not self._durable)
            self._cache.clear()


class OptimizerStateSwapper:
    """NVMe-resident Adam moments (fp32). Reads are double-buffered on a
    handle of their own: ``prefetch(next)`` starts reading the next
    leaf's moments while the caller steps the current one, and
    ``fetch`` hands out the staged buffers. With ``pipeline_write`` the
    stores are write-behind on a third handle (the updated moments, which
    are usually the very buffers ``fetch`` handed out, are written while
    the next leaves step; at most ``buffer_count`` leaves in flight);
    otherwise they are synchronous."""

    FIELDS = ("exp_avg", "exp_avg_sq")

    def __init__(self, nvme_path, aio_config=None, pipeline_write=False,
                 buffer_count=2, registry=None):
        self.swapper = TensorSwapper(nvme_path, aio_config, "optimizer_swap")
        self.shapes = {}
        self._aio_config = aio_config
        self._pf_handle = aio_lib.make_handle(aio_config)
        self._pf = None          # (leaf, [bufs], [fds], [tids])
        self.pipeline_write = bool(pipeline_write)
        self.buffer_count = max(2, int(buffer_count))
        self._arena = _StagingArena(
            slots=4 + (2 * self.buffer_count if pipeline_write else 0),
            aligned=getattr(aio_config, "o_direct", False))
        self._consumed = {}      # leaf -> [tids] handed out by fetch
        self._wb_handle = None
        self._wb_live = []       # (leaf, [tids], [buffers]) in flight
        self._wb_pending = set()
        self._wb_fds = {}
        self._wb_sizes = {}
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._stall_s = 0.0
        self._fd_finalizer = weakref.finalize(
            self, _close_fds_and_rm, self.swapper.dir, self._wb_fds,
            remove=False)

    @property
    def handle(self):
        return self.swapper.handle

    def take_stall_s(self):
        s, self._stall_s = self._stall_s, 0.0
        return s

    def init_state(self, leaf, shape):
        self.shapes[leaf] = tuple(shape)
        zeros = torch.zeros(shape, dtype=torch.float32)
        for field in self.FIELDS:
            self.swapper.swap_out(f"{leaf}.{field}", zeros)
        self.registry.counter("swap/bytes_written").inc(2 * zeros.numel() * 4)

    def _drain_prefetch(self):
        if self._pf is None:
            return None
        leaf, bufs, fds, tids = self._pf
        self._pf = None
        t0 = time.perf_counter()
        try:
            self._pf_handle.wait()
        finally:
            self._stall_s += time.perf_counter() - t0
            for fd in fds:
                self._pf_handle.close(fd)
        return leaf, bufs, tids

    def _discard_prefetch(self):
        drained = self._drain_prefetch()
        if drained is not None:
            for tid in drained[2]:
                self._arena.give(tid)

    def _release_consumed(self, leaf):
        for tid in self._consumed.pop(leaf, ()):
            self._arena.give(tid)

    def drain_writes(self):
        """The store-behind fence: wait, then free the staging that
        backed the writes."""
        if not self._wb_live:
            return
        t0 = time.perf_counter()
        try:
            self._wb_handle.wait()
        finally:
            self._stall_s += time.perf_counter() - t0
        for _, tids, _ in self._wb_live:
            for tid in tids:
                self._arena.give(tid)
        self._wb_live = []
        self._wb_pending.clear()

    def prefetch(self, leaf):
        """Start reading ``leaf``'s moments; ``fetch(leaf)`` takes them."""
        if self._pf is not None and self._pf[0] == leaf:
            return
        if leaf in self._wb_pending:
            self.drain_writes()
        self._discard_prefetch()
        shape = self.shapes[leaf]
        bufs, fds, tids = [], [], []
        for field in self.FIELDS:
            tid, buf = self._arena.take(shape)
            fd = self._pf_handle.open(self.swapper._path(f"{leaf}.{field}"),
                                      False)
            self._pf_handle.async_pread(buf, fd)
            bufs.append(buf)
            fds.append(fd)
            tids.append(tid)
        self.registry.counter("swap/bytes_read").inc(
            sum(b.numel() * 4 for b in bufs))
        self._pf = (leaf, bufs, fds, tids)

    def fetch(self, leaf):
        """[exp_avg, exp_avg_sq] of ``leaf``, fp32 staging buffers valid
        until its ``store`` (or the next ``fetch`` of it)."""
        self._release_consumed(leaf)
        if leaf in self._wb_pending:
            self.drain_writes()
        if self._pf is not None and self._pf[0] == leaf:
            _, bufs, tids = self._drain_prefetch()
            self._consumed[leaf] = tids
            return bufs
        self._discard_prefetch()
        shape = self.shapes[leaf]
        out, tids = [], []
        t0 = time.perf_counter()
        for field in self.FIELDS:
            tid, buf = self._arena.take(shape)
            self.swapper.swap_in(f"{leaf}.{field}", buf)
            out.append(buf)
            tids.append(tid)
        self._stall_s += time.perf_counter() - t0
        self.registry.counter("swap/bytes_read").inc(
            sum(b.numel() * 4 for b in out))
        self._consumed[leaf] = tids
        return out

    def store(self, leaf, exp_avg, exp_avg_sq):
        if self.pipeline_write:
            return self._store_behind(leaf, exp_avg, exp_avg_sq)
        t0 = time.perf_counter()
        self.swapper.swap_out(f"{leaf}.exp_avg", exp_avg)
        self.swapper.swap_out(f"{leaf}.exp_avg_sq", exp_avg_sq)
        self._stall_s += time.perf_counter() - t0
        self.registry.counter("swap/bytes_written").inc(
            (exp_avg.numel() + exp_avg_sq.numel()) * 4)
        self._release_consumed(leaf)

    def _store_behind(self, leaf, exp_avg, exp_avg_sq):
        """Hand the fetched staging buffers themselves to the write handle
        (the step updated them in place) and free them at the drain;
        other tensors are copied into fresh staging first."""
        if leaf in self._wb_pending or \
                len(self._wb_live) >= self.buffer_count:
            self.drain_writes()
        mine = self._consumed.pop(leaf, None)
        arrs = [exp_avg, exp_avg_sq]
        staged = None
        if mine is not None:
            staged = [self._arena.arena.get_tensor(t) if t is not None
                      else None for t in mine]
        if mine is not None and all(
                s is not None and a.data_ptr() == s.data_ptr()
                for a, s in zip(arrs, staged)):
            tids = mine
        else:
            if mine is not None:
                for tid in mine:
                    self._arena.give(tid)
            tids, copies = [], []
            for a in arrs:
                tid, buf = self._arena.take(tuple(a.shape))
                buf.copy_(a)
                tids.append(tid)
                copies.append(buf)
            arrs = copies
        if self._wb_handle is None:
            self._wb_handle = aio_lib.make_handle(self._aio_config)
        for field, a in zip(self.FIELDS, arrs):
            nbytes = a.numel() * 4
            self._wb_handle.async_pwrite(
                a.contiguous(), self._wb_fd(leaf, field, nbytes))
        self._wb_live.append((leaf, tids, arrs))
        self._wb_pending.add(leaf)
        self.registry.counter("swap/bytes_written").inc(
            sum(a.numel() * 4 for a in arrs))

    def _wb_fd(self, leaf, field, nbytes):
        """The cached, preallocated, no-O_TRUNC write fd of a moment file."""
        key = (leaf, field)
        fd = self._wb_fds.get(key)
        if fd is None:
            fd = self.handle.open_fd(self.swapper._path(f"{leaf}.{field}"),
                                     os.O_WRONLY | os.O_CREAT)
            self._wb_fds[key] = fd
        alloc = self.handle.io_nbytes(nbytes)
        if self._wb_sizes.get(key) != alloc:
            _preallocate(fd, alloc)
            self._wb_sizes[key] = alloc
        return fd

    def release(self):
        try:
            self._discard_prefetch()
            self.drain_writes()
        finally:
            for leaf in list(self._consumed):
                self._release_consumed(leaf)
            _close_fds_and_rm(self.swapper.dir, self._wb_fds, remove=False)
            self.swapper.release()
