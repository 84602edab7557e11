"""chip_smoke.py's ZeRO-Offload phases alone, on the card.

    python3 tests/perf/torch_offload_phases.py [--only streamed,host,parity,nvme]

Runs chip_smoke's device phase (the card, the builds, the host and the
pinned copy rates), then ``train_llama_offload`` (the streamed tier),
``train_llama_offload_host`` (the native SIMD step), ``offload_parity``
and ``train_nvme`` (GPT-2 large with the moments and the parameters on
the disk; the GPT-2 train phase runs first, 2 + 10 steps, for the losses
it is held to). Each prints its chip_smoke line; ``--only`` picks some.
"""

import os
import sys
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import chip_smoke as c  # noqa: E402

PHASES = ("streamed", "host", "parity", "nvme")


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    only = PHASES
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
    smi, rates = c.phase_device()

    def nvme():
        engine, _, _ = c.train_phase()
        del engine
        c.free_host_caches()
        c.train_nvme_phase()
    runs = {"streamed": lambda: c.train_llama_offload_phase(rates),
            "host": lambda: c.train_llama_offload_phase(rates,
                                                        stream="host"),
            "parity": c.offload_parity_phase, "nvme": nvme}
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
