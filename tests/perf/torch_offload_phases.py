"""chip_smoke.py's ZeRO-Offload phases alone, on the card.

    python3 tests/perf/torch_offload_phases.py \
        [--only streamed,host,parity,nvme,infinity,nvme_xl,param_offload]

Runs chip_smoke's device phase (the card, the builds, the host and the
pinned copy rates), then ``train_llama_offload`` (the streamed tier),
``train_llama_offload_host`` (the native SIMD step), ``offload_parity``
``train_nvme`` (GPT-2 large with the moments and the parameters on
the disk; the GPT-2 train phase runs first, 2 + 10 steps, for the losses
it is held to), the ZeRO-Infinity phases (``infinity``: the flash rows
at its shape, ``train_infinity`` on the 6.25B GPT-2, ``infinity_restore``
and ``infinity_parity``), ``nvme_xl`` (10.64B bf16 through
``swap_in_stream``) and ``param_offload`` (GPT-2 large with
``offload_param`` cpu, then nvme without offload_optimizer; after the
train phase too). Each prints its chip_smoke line; ``--only`` picks
some.
"""

import os
import shutil
import sys
import tempfile
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import chip_smoke as c  # noqa: E402

PHASES = ("streamed", "host", "parity", "nvme", "infinity", "nvme_xl",
          "param_offload")


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    only = PHASES
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
    smi, rates = c.phase_device()

    def train_losses():
        if not c.TRAIN_LOSSES:
            engine, _, _ = c.train_phase()
            del engine
            c.free_host_caches()

    def nvme():
        train_losses()
        c.train_nvme_phase()

    def in_dir(fn, *args):
        def run():
            path = tempfile.mkdtemp(prefix="dstpu_phase_")
            try:
                fn(*args, path)
            finally:
                shutil.rmtree(path, ignore_errors=True)
        return run

    def infinity(path):
        gen = torch.Generator(device="cuda").manual_seed(0)
        c.flash_rows(gen, c.INF_BATCH, "train_infinity", H=c.INF_HEADS,
                     S=c.INF_SEQ, D=c.INF_E // c.INF_HEADS)
        engine, batch, _, losses = c.train_infinity_phase(rates, path)
        c.infinity_restore_phase(engine, batch, losses, path)
        del engine
        c.infinity_parity_phase()

    def param_offload(path):
        train_losses()
        c.param_offload_phase(path)
    runs = {"streamed": lambda: c.train_llama_offload_phase(rates),
            "host": lambda: c.train_llama_offload_phase(rates,
                                                        stream="host"),
            "parity": c.offload_parity_phase, "nvme": nvme,
            "infinity": in_dir(infinity), "nvme_xl": in_dir(c.nvme_xl_phase),
            "param_offload": in_dir(param_offload)}
    failed = []
    for name in PHASES:
        if name not in only:
            continue
        try:
            runs[name]()
        except Exception:        # report each phase, run the others
            traceback.print_exc()
            failed.append(name)
            c.free_host_caches()
    for line in smi:
        print(line, flush=True)
    if failed:
        print(f"failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
