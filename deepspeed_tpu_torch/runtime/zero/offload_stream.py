"""ZeRO-Offload with the optimizer state in pinned host memory and the
update on the card: the streamed tier.

Port of ``deepspeed_tpu/runtime/zero/offload_stream.py``. The fp32
master, ``exp_avg`` (in the optimizer's ``moment_dtype``) and the fp32
``exp_avg_sq`` rest in host memory, page-locked on CUDA (``pinned.py``);
the card holds the compute-dtype parameters and the gradients. A step
streams the state through the card:

    host state --h2d--> device slot --Adam--> device slot --d2h--> host
                                        \\--> compute-dtype params

Leaves whose fp32 bytes exceed ``unit_bytes`` are split along dim 0
(``_Unit``, as JAX splits them), and consecutive units are packed into
groups of at most ``unit_bytes`` of fp32 state. The host arenas lay the
units out in order, so a group is one contiguous range of each arena:
three host-to-device copies in, three device-to-host copies out. Groups
take turns in two device slots. Three streams ordered by CUDA events
carry them: the h2d stream loads group k into slot k % 2 once the d2h
of group k - 2 has left it, the compute stream runs the port's
``FusedAdam`` math on the slot (``_step_group``, the device optimizer's
arithmetic) and writes the updated parameters into the resident
compute copy, and the d2h stream writes the slot back. The host never
synchronizes within a step; the copies in and out run on the two copy
engines at once. The gradients never leave the card.

On the CPU (the tests) the same code runs on plain tensors, the streams
and events standing aside: JAX's "collapsed memory spaces" case, where
host memory is device memory.
"""

import contextlib
import dataclasses
import logging
import math
from typing import List

import torch

from deepspeed_tpu_torch.config.config import ROADMAP_LAMB_SGD
from deepspeed_tpu_torch.ops.adam import FusedAdam
from deepspeed_tpu_torch.runtime.zero.pinned import PinnedBuffer

logger = logging.getLogger("deepspeed_tpu_torch")

UNIT_BYTES = 512 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class _Unit:
    """Rows [start, stop) of leaf ``leaf``; 0/0 for a whole leaf."""
    leaf: int
    start: int
    stop: int

    @property
    def split(self):
        return self.stop > 0


def split_units(shapes, unit_bytes=UNIT_BYTES):
    """The units of leaves of ``shapes``: a leaf of more than
    ``unit_bytes`` fp32 bytes with a leading dim > 1 splits into
    ceil(bytes / unit_bytes) row ranges of equal height (the last
    shorter); others stay whole."""
    units = []
    for i, shape in enumerate(shapes):
        nbytes = math.prod(shape) * 4
        d0 = shape[0] if shape else 1
        if nbytes <= unit_bytes or d0 <= 1:
            if nbytes > 2 * unit_bytes:
                logger.warning(f"streamed offload: leaf {i} {tuple(shape)} "
                               f"({nbytes >> 20} MiB fp32) cannot be split "
                               f"along dim 0; it streams as one window")
            units.append(_Unit(i, 0, 0))
            continue
        k = -(-nbytes // unit_bytes)
        rows = -(-d0 // k)
        for s in range(0, d0, rows):
            units.append(_Unit(i, s, min(s + rows, d0)))
    return units


def pack_groups(units, numel_of, unit_bytes=UNIT_BYTES):
    """Consecutive units packed into groups of at most ``unit_bytes`` of
    fp32 state (a larger unit alone)."""
    groups, cur, cur_b = [], [], 0
    for u in units:
        b = numel_of(u) * 4
        if cur and cur_b + b > unit_bytes:
            groups.append(cur)
            cur, cur_b = [], 0
        cur.append(u)
        cur_b += b
    if cur:
        groups.append(cur)
    return groups


class StreamedOffloadOptimizer:
    """Adam/AdamW with the fp32 master and the moments in host memory.

    ``step(grads, params, lr, grad_scale)`` updates the state and writes
    the updated parameters into ``params`` (the resident compute copy,
    any float dtype); ``lr`` and ``grad_scale`` may be device tensors,
    so a step reads nothing back. At world size n ``masters`` and
    ``params`` are a rank's slices, views that may be strided (a slice
    on a dim other than 0): the copies in and out take them as views.
    ``master_leaves``, ``state_dict`` and ``load_state_dict`` give and
    take whole fp32 leaves on the CPU (they synchronize)."""

    def __init__(self, masters, optimizer, device, unit_bytes=UNIT_BYTES):
        if not isinstance(optimizer, FusedAdam):
            raise NotImplementedError(
                f"the streamed offload tier runs Adam/AdamW; "
                f"{type(optimizer).__name__} is not ported "
                f"({ROADMAP_LAMB_SGD})")
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.step_count = 0
        self.mdtype = torch.bfloat16 if optimizer.moment_dtype == "bf16" \
            else torch.float32
        self.shapes = [tuple(m.shape) for m in masters]
        self.units: List[_Unit] = split_units(self.shapes, unit_bytes)
        self.groups = pack_groups(self.units, self._unit_numel, unit_bytes)
        self._offset = {}
        off = 0
        for u in self.units:
            self._offset[u] = off
            off += self._unit_numel(u)
        total = off
        # master and exp_avg_sq share one fp32 arena, exp_avg has its own
        self._state32 = PinnedBuffer(2 * total, torch.float32, self.cuda)
        self._m = PinnedBuffer(total, self.mdtype, self.cuda)
        self.init_s = {"touch_s": self._state32.touch_s + self._m.touch_s,
                       "register_s": self._state32.register_s
                       + self._m.register_s}
        self._master = self._state32.tensor[:total]
        self._v = self._state32.tensor[total:]
        with torch.no_grad():
            for u in self.units:
                self._host_view(self._master, u).copy_(
                    self._slice(masters[u.leaf], u))
        most = max((sum(self._unit_numel(u) for u in g)
                    for g in self.groups), default=0)
        dev = self.device
        self._slots = [(torch.empty(most, dtype=torch.float32, device=dev),
                        torch.empty(most, dtype=self.mdtype, device=dev),
                        torch.empty(most, dtype=torch.float32, device=dev))
                       for _ in range(2 if self.cuda else 1)]
        if self.cuda:
            self._streams = [torch.cuda.Stream(dev) for _ in range(3)]
            self._events = {k: [torch.cuda.Event() for _ in range(2)]
                            for k in ("loaded", "computed", "stored")}
        # with ``timed`` set, each step keeps timing events around every
        # group's copies in, update and copies out (``spans``)
        self.timed = False
        self.spans = None
        logger.info(
            f"StreamedOffloadOptimizer: {len(self.shapes)} leaves -> "
            f"{len(self.units)} units in {len(self.groups)} groups; "
            f"{self.host_bytes / 1e9:.1f} GB of state in "
            f"{'pinned ' if self.cuda else ''}host memory")

    # -- geometry --------------------------------------------------------
    def _unit_shape(self, u):
        shape = self.shapes[u.leaf]
        return shape if not u.split else (u.stop - u.start,) + shape[1:]

    def _unit_numel(self, u):
        return math.prod(self._unit_shape(u))

    @staticmethod
    def _slice(t, u):
        return t if not u.split else t[u.start:u.stop]

    def _host_view(self, arena, u):
        off = self._offset[u]
        return arena[off:off + self._unit_numel(u)].view(self._unit_shape(u))

    def _group_range(self, g):
        lo = self._offset[g[0]]
        return lo, lo + sum(self._unit_numel(u) for u in g)

    @property
    def store_stream(self):
        """The stream that copies the updated state back to the host (the
        step's last work on the card), or None off the card."""
        return self._streams[2] if self.cuda else None

    @property
    def host_bytes(self):
        return self._state32.nbytes + self._m.nbytes

    def close(self):
        """Unregister and free the host state (waits for the card)."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self._master = self._v = None
        self._state32.close()
        self._m.close()
        self._slots = []

    # -- the step --------------------------------------------------------
    def _stream(self, i):
        return torch.cuda.stream(self._streams[i]) if self.cuda \
            else contextlib.nullcontext()

    def _span(self, kind, i):
        """A (start, end) pair of timing events on stream ``i`` around the
        block, kept in ``spans[kind]`` when the step is timed."""
        if not (self.timed and self.cuda):
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def span():
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record(self._streams[i])
            yield
            pair[1].record(self._streams[i])
            self.spans[kind].append(pair)
        return span()

    def span_ms(self):
        """The last timed step's device milliseconds on each stream,
        summed over the groups: {"h2d", "adam", "d2h"} (they overlap);
        synchronizes."""
        self._sync()
        return {k: sum(a.elapsed_time(b) for a, b in pairs)
                for k, pairs in self.spans.items()}

    def step(self, grads, params, lr, grad_scale=None):
        opt = self.optimizer
        self.step_count += 1
        beta1, beta2 = opt.betas
        count = torch.tensor(self.step_count, dtype=torch.int32,
                             device=self.device)
        bc1 = bc2 = None
        if opt.bias_correction:
            cf = count.float()
            bc1 = 1.0 - torch.pow(beta1, cf)
            bc2 = 1.0 - torch.pow(beta2, cf)
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            h2d, comp, d2h = self._streams
            comp.wait_stream(cur)     # the gradients, lr, scale, bc
            h2d.wait_stream(d2h)      # last step's state is back on host
            ev = self._events
        self.spans = {"h2d": [], "adam": [], "d2h": []}
        with torch.no_grad():
            for k, g in enumerate(self.groups):
                s = k % len(self._slots)
                lo, hi = self._group_range(g)
                n = hi - lo
                dp, dm, dv = (t[:n] for t in self._slots[s])
                with self._stream(0):
                    if self.cuda and k >= 2:
                        h2d.wait_event(ev["stored"][s])
                    with self._span("h2d", 0):
                        dp.copy_(self._master[lo:hi], non_blocking=True)
                        dm.copy_(self._m.tensor[lo:hi], non_blocking=True)
                        dv.copy_(self._v[lo:hi], non_blocking=True)
                    if self.cuda:
                        ev["loaded"][s].record(h2d)
                with self._stream(1):
                    if self.cuda:
                        comp.wait_event(ev["loaded"][s])
                    views = [[], [], [], []]
                    for u in g:
                        a = self._offset[u] - lo
                        b = a + self._unit_numel(u)
                        shape = self._unit_shape(u)
                        views[0].append(dp[a:b].view(shape))
                        views[1].append(self._slice(grads[u.leaf], u))
                        views[2].append(dm[a:b].view(shape))
                        views[3].append(dv[a:b].view(shape))
                    with self._span("adam", 1):
                        opt._step_group(*views, lr, grad_scale, None, beta1,
                                        beta2, bc1, bc2)
                        for u, p32 in zip(g, views[0]):
                            self._slice(params[u.leaf], u).copy_(p32)
                    if self.cuda:
                        ev["computed"][s].record(comp)
                with self._stream(2):
                    if self.cuda:
                        d2h.wait_event(ev["computed"][s])
                    with self._span("d2h", 2):
                        self._master[lo:hi].copy_(dp, non_blocking=True)
                        self._m.tensor[lo:hi].copy_(dm, non_blocking=True)
                        self._v[lo:hi].copy_(dv, non_blocking=True)
                    if self.cuda:
                        ev["stored"][s].record(d2h)
        if self.cuda:
            # the next forward reads the parameters; the gradients may be
            # freed once the compute stream is done with them
            cur.wait_stream(comp)

    # -- checkpoints -----------------------------------------------------
    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _gather(self, arena, leaf):
        parts = [self._host_view(arena, u) for u in self.units
                 if u.leaf == leaf]
        full = parts[0] if len(parts) == 1 else torch.cat(parts)
        return full.float().clone()

    def master_leaves(self):
        """Every leaf's fp32 master, on the CPU."""
        self._sync()
        return [self._gather(self._master, i)
                for i in range(len(self.shapes))]

    def load_master_leaves(self, masters):
        self._sync()
        with torch.no_grad():
            for u in self.units:
                self._host_view(self._master, u).copy_(
                    self._slice(masters[u.leaf], u))

    def state_dict(self):
        """{"step", "exp_avg", "exp_avg_sq"}: fp32 leaves on the CPU."""
        self._sync()
        n = len(self.shapes)
        return {"step": self.step_count,
                "exp_avg": [self._gather(self._m.tensor, i)
                            for i in range(n)],
                "exp_avg_sq": [self._gather(self._v, i) for i in range(n)]}

    def load_state_dict(self, sd):
        self._sync()
        self.step_count = int(sd["step"])
        with torch.no_grad():
            for u in self.units:
                self._host_view(self._m.tensor, u).copy_(
                    self._slice(sd["exp_avg"][u.leaf], u))
                self._host_view(self._v, u).copy_(
                    self._slice(sd["exp_avg_sq"][u.leaf], u))
