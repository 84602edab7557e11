"""The world descriptor: the port's counterpart of ``MeshConfig`` /
``make_mesh`` and ``DATA_AXIS`` (``deepspeed_tpu/parallel/mesh.py``).

The JAX package names a mesh axis where the reference builds a process
group; the port runs one process a rank over ``torch.distributed`` and
describes the world it joined: its rank and size along the one data axis,
the card of each rank (``cuda:local_rank % device_count``, stated
explicitly, so several ranks may share one card) or the CPU. Host-side
work (barriers, the exchange of the heap's IPC handles, and every
collective on the CPU) runs over gloo; on the card the collectives read
the peers' views of the symmetric heap (``symmetric_memory.py``).

``spawn`` starts an n-rank run on one host: n processes by ``spawn`` (not
fork), each joining a gloo group at ``tcp://127.0.0.1:<free port>``.
"""

import dataclasses
import datetime
import os
import queue as queue_lib
import socket
import time
import traceback

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.config.config import (ROADMAP_LONG_CONTEXT,
                                               ROADMAP_MULTI_RANK)
from deepspeed_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes, as ``deepspeed_tpu.parallel.mesh.MeshConfig``. The port
    runs the data axis alone."""
    data: int = 1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1


class Mesh:
    """One rank's view of a data-parallel world (the default process
    group, gloo): ``rank``, ``size``, ``device``, and the symmetric
    ``heap`` the engine makes on the card (None on the CPU).
    ``barriers`` counts ``barrier()`` calls and ``barrier_s`` the host
    seconds spent in them (the wait for this rank's queued kernels
    included)."""

    def __init__(self, size, rank, device):
        self.size, self.rank = int(size), int(rank)
        self.device = torch.device(device)
        self.heap = None
        self.barriers = 0
        self.barrier_s = 0.0

    @property
    def shape(self):
        return {DATA_AXIS: self.size}

    def barrier(self):
        """Every queued kernel of this process finished, then a gloo
        barrier: what one rank wrote before it is visible to every rank
        after it."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.size > 1:
            dist.barrier()
        self.barriers += 1
        self.barrier_s += time.perf_counter() - t0

    def all_gather(self, t):
        """Every rank's ``t`` (same shape and dtype), in rank order, over
        gloo: the CPU's exchange (the bytes travel, so any dtype goes)."""
        if self.size == 1:
            return [t]
        flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
        out = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(out, flat)
        return [o.view(t.dtype).reshape(t.shape) for o in out]

    def __repr__(self):
        return f"Mesh(data={self.size}, rank={self.rank}, " \
            f"device={self.device})"


def rank_device(rank, device=None):
    """The card of ``rank``: ``cuda:local_rank % device_count`` (LOCAL_RANK,
    else the rank), or the CPU when ``device`` says so."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


# the ROADMAP item that ports each refused axis (seq: ring / Ulysses)
_AXIS_ROADMAP = {"model": ROADMAP_MULTI_RANK, "pipe": ROADMAP_MULTI_RANK,
                 "seq": ROADMAP_LONG_CONTEXT, "expert": ROADMAP_MULTI_RANK}


def make_mesh(config=None, device=None):
    """The world this process joined (``torch.distributed`` initialized,
    gloo) as a ``Mesh`` of ``config.data`` ranks. Only the data axis is
    ported; its size must be the world's."""
    config = config or MeshConfig(data=dist.get_world_size()
                                  if dist.is_initialized() else 1)
    for axis in ("model", "pipe", "seq", "expert"):
        if getattr(config, axis) > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={getattr(config, axis)} is not ported; "
                f"the port runs a data axis alone ({_AXIS_ROADMAP[axis]})")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if config.data != world:
        raise ValueError(f"mesh data={config.data} must equal the "
                         f"torch.distributed world size {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(world, rank, dev)


def _free_port():
    """A free TCP port on this host's loopback."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_main(rank, world, port, fn, args, results):
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                      # noqa: B036 (reported)
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world, *args, timeout=600.0):
    """Run ``fn(rank, world, *args)`` in ``world`` processes (start method
    ``spawn``), each in a gloo group; return their results in rank order
    (picklable values: move tensors to the CPU first). A rank that raises
    or dies, or a run past ``timeout`` seconds, raises here, after every
    process has been stopped."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_spawn_main,
                         args=(r, world, port, fn, args, results),
                         daemon=False) for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(1.0)
                    if results.empty():
                        errors.append(f"rank {procs.index(dead[0])} exited "
                                      f"with code {dead[0].exitcode}")
                        break
                if time.monotonic() > deadline:
                    errors.append(f"timed out after {timeout} s")
                    break
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=30.0 if not errors else 5.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
    if errors:
        raise RuntimeError("spawned run failed:\n" + "\n".join(errors))
    return [got[r] for r in range(world)]
