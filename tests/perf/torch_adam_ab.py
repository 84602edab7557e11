"""The training steps that FusedAdam's leaf groups touch, from one tree,
on one NVIDIA GPU.

    python3 tests/perf/torch_adam_ab.py [--tree DIR]

Runs chip_smoke.py's ``train`` phase (GPT-2 large, 8 x 1024, 2 warm-up and
10 timed steps) and ``train_bert_sparse`` phase (BERT-large, block-sparse
attention, 4 x 4096) with the package and chip_smoke.py of the checkout at
DIR (default: this one), printing their JSON lines, and between them the
AdamW step alone over the GPT-2 engine's fp32 masters and state (bf16
gradients of N(0, 1e-3)): median of 25 CUDA-event windows of 4 steps, as
the tree's ``FusedAdam`` does it and, where the tree groups its leaves
(``ops/adam.GROUP_ELEMENTS``), also as one group of every leaf. One JSON
line: ``{"phase": "adam_step", ...}``. Compare two trees in one call by
running it on each in turns (old, new, new, old): DIR is a directory that
.gitignore lists, holding ``git archive`` of the other commit.
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TREE = os.path.abspath(sys.argv[sys.argv.index("--tree") + 1]) \
    if "--tree" in sys.argv else ROOT
sys.path.insert(0, TREE)

import chip_smoke as c  # noqa: E402


def adam_step_ms(engine):
    """{variant: ms} of one optimizer step over ``engine``'s leaves."""
    from deepspeed_tpu_torch.ops import adam
    gen = torch.Generator(device="cuda").manual_seed(0)
    grads = [torch.randn(m.shape, generator=gen, device="cuda")
             .mul_(1e-3).to(torch.bfloat16) for m in engine.master]
    lr = torch.tensor(1e-4, device="cuda")

    def step():
        engine.optimizer.step(engine.master, grads, engine.opt_state, lr)
    out = {"grouped" if hasattr(adam, "GROUP_ELEMENTS") else "one_group":
           c.time_ms(step, inner=4)}
    if hasattr(adam, "GROUP_ELEMENTS"):
        keep = adam.GROUP_ELEMENTS
        adam.GROUP_ELEMENTS = 1 << 62
        try:
            out["one_group"] = c.time_ms(step, inner=4)
        finally:
            adam.GROUP_ELEMENTS = keep
    return out


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = c.phase_device()    # a tree with the offload phases gives
    if isinstance(smi, tuple):  # (lines, pinned rates)
        smi = smi[0]
    for line in smi:
        print(line, flush=True)
    engine, batch, _ = c.train_phase()
    ms = adam_step_ms(engine)
    print(json.dumps({"phase": "adam_step", "tree": TREE,
                      "leaves": len(engine.master),
                      "elements": sum(m.numel() for m in engine.master),
                      "step_ms": ms}), flush=True)
    del engine, batch
    torch.cuda.empty_cache()
    c.train_bert_sparse_phase()
    return 0


if __name__ == "__main__":
    sys.exit(main())
