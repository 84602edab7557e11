"""Page-locked host tensors for the offload tiers.

``torch.empty(..., pin_memory=True)`` rounds each allocation up to a
power of two, which would cost the streamed tier up to twice its 67 GB of
LLaMA-7B state. ``PinnedBuffer`` instead allocates one plain CPU tensor
of the exact size, touches its pages with a parallel fill, and
registers it with ``cudaHostRegister``; views of it are pinned, so
copies between them and the card run asynchronously on a side stream.
On the CPU it is a plain tensor. On CUDA a failure to register raises:
there is no pageable fallback. ``HostParamRest`` is the parameter tier
``offload_param: {device: cpu}`` on such a buffer.
"""

import contextlib
import time

import torch


class PinnedBuffer:
    """``numel`` elements of ``dtype`` in host memory, page-locked when
    ``pin`` (``.tensor`` is the flat tensor; ``close()`` unregisters it).
    ``register_s`` and ``touch_s`` time the two halves of pinning."""

    def __init__(self, numel, dtype, pin):
        t0 = time.perf_counter()
        self.tensor = torch.zeros(int(numel), dtype=dtype)
        self.touch_s = time.perf_counter() - t0
        self.register_s = 0.0
        self.pinned = False
        if pin and self.tensor.numel():
            t0 = time.perf_counter()
            nbytes = self.tensor.numel() * self.tensor.element_size()
            err = torch.cuda.cudart().cudaHostRegister(
                self.tensor.data_ptr(), nbytes, 0)
            if int(err) != 0:
                raise RuntimeError(
                    f"cudaHostRegister of {nbytes / 1e9:.1f} GB of host "
                    f"memory failed ({err}): the offload tier's state must "
                    f"be page-locked on CUDA")
            self.pinned = True
            self.register_s = time.perf_counter() - t0
            if not self.tensor.is_pinned():
                self.close()
                raise RuntimeError("registered host memory does not report "
                                   "as pinned")

    @property
    def nbytes(self):
        return self.tensor.numel() * self.tensor.element_size()

    def close(self):
        if self.pinned:
            torch.cuda.cudart().cudaHostUnregister(self.tensor.data_ptr())
            self.pinned = False
        self.tensor = None

    def __del__(self):
        if getattr(self, "pinned", False):
            self.close()


class HostParamRest:
    """The parameter tier ``offload_param: {device: cpu}``: tensors rest
    between steps in one exact-size host arena (a ``PinnedBuffer``,
    page-locked on CUDA), their card memory freed, and come back before
    anything reads them. Both copies run on a copy stream of their own,
    ordered after the work that made the tensors and before the work
    that reads them; a parked tensor is kept from reuse until its copy
    has read it (``record_stream``). On the CPU the same copies run on
    a plain tensor. ``last_ms()`` is (park, unpark) device time of the
    last of each, by CUDA events (None off the card)."""

    ALIGN = 64

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._buf = None
        self._views = None
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._events = {}

    @property
    def nbytes(self):
        return 0 if self._buf is None else self._buf.nbytes

    def _layout(self, tensors):
        offs, off = [], 0
        for t in tensors:
            offs.append(off)
            n = t.numel() * t.element_size()
            off += -(-n // self.ALIGN) * self.ALIGN
        self._buf = PinnedBuffer(off, torch.uint8, self.cuda)
        raw = self._buf.tensor
        self._views = [raw[o:o + t.numel() * t.element_size()]
                       .view(t.dtype).view(t.shape)
                       for o, t in zip(offs, tensors)]

    def _mark(self, key):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            self._events[key] = ev

    def park(self, tensors):
        """Copy ``tensors`` into the arena (laid out at the first park;
        later parks must bring the same shapes and dtypes)."""
        if self._buf is None:
            self._layout(tensors)
        if self.cuda:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with _on(self._stream):
            self._mark("park0")
            for v, t in zip(self._views, tensors):
                v.copy_(t, non_blocking=True)
                if self.cuda:
                    t.record_stream(self._stream)
            self._mark("park1")

    def unpark(self):
        """New device tensors with the parked values; the current stream
        waits for their copies."""
        outs = [torch.empty(v.shape, dtype=v.dtype, device=self.device)
                for v in self._views]
        if self.cuda:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with _on(self._stream):
            self._mark("unpark0")
            for o, v in zip(outs, self._views):
                o.copy_(v, non_blocking=True)
            self._mark("unpark1")
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return outs

    def last_ms(self):
        ev = self._events
        if not self.cuda or "park1" not in ev or "unpark1" not in ev:
            return None
        ev["unpark1"].synchronize()
        return (ev["park0"].elapsed_time(ev["park1"]),
                ev["unpark0"].elapsed_time(ev["unpark1"]))

    def close(self):
        if self.cuda:
            self._stream.synchronize()
        self._views = None
        if self._buf is not None:
            self._buf.close()
            self._buf = None


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()
