"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu`` for
one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``deepspeed_tpu`` is the reference this package is held
against; this package imports nothing of it. Every Pallas kernel on a
ported path is a hand-written CUDA kernel here (``csrc/*.cu``, wrapped in
``ops/cuda/``), each beside its plain PyTorch version. Entry points run
on the card unless the caller passes ``device="cpu"``.

Ported so far: GPT-2 paged serving (``serving.build_engine``). Training
(``initialize``) is the next slice (ROADMAP.md queue 1).
"""

__version__ = "0.1.0"
