"""Page-locked host tensors for the offload tiers.

``torch.empty(..., pin_memory=True)`` rounds each allocation up to a
power of two, which would cost the streamed tier up to twice its 67 GB of
LLaMA-7B state. ``PinnedBuffer`` instead allocates one plain CPU tensor
of the exact size, touches its pages with a parallel fill, and
registers it with ``cudaHostRegister``; views of it are pinned, so
copies between them and the card run asynchronously on a side stream.
On the CPU it is a plain tensor. On CUDA a failure to register raises:
there is no pageable fallback.
"""

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
