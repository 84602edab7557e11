"""What ptxas gives each named kernel of the port: registers, spills and
shared memory, from ``nvcc -Xptxas=-v`` with the build's own flags.

    python3 tests/perf/torch_ptxas.py [NAME ...]

Compiles every ``csrc/*.cu`` into a scratch directory (the cached library
is left alone) and prints, for each kernel whose mangled name contains one
of NAME (default: the TMA- or bulk-copy-fed kernels, each head dim and
variant its own instantiation: the flash kernels, the decode projections
(every prologue, epilogue, pairing, weight type and slot width), the
fused GEMMs, decode attention, the block-sparse forward and dq, and
dk/dv), ptxas's lines for
it. Needs
``nvcc``: run it on the machine with the card.
"""

import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from deepspeed_tpu_torch.ops.cuda import builder  # noqa: E402

DEFAULT = ("flash_fwd_tma_kernel", "flash_bwd_tma_kernel",
           "proj_tma_kernel", "gemm_tma_kernel", "decode_attn_kernel",
           "bs_rows_tma_kernel", "bs_dkv_tma_kernel")


def main(names):
    nvcc = builder._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for src in builder.sources():
            cmd = [nvcc, "-Xptxas=-v", *builder.NVCC_FLAGS, "-c", src, "-o",
                   os.path.join(tmp, os.path.basename(src) + ".o")]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                print(out)
                raise SystemExit(f"nvcc failed on {src}")
            current, props = None, {}
            for line in out.splitlines():
                m = re.search(r"(?:Compiling entry function|Function "
                              r"properties for) '?(\w+)'?", line)
                if m:
                    current = m.group(1)
                    continue
                hit = current and next((n for n in names if n in current),
                                       None)
                if hit and ("bytes" in line or "registers" in line):
                    # the kernel's name from its own, template arguments
                    # still mangled
                    short = current[current.index(hit):]
                    props.setdefault(short, []).append(
                        line.split(":", 1)[-1].strip())
            for short, lines in props.items():
                print(f"{os.path.basename(src)}: {short}: "
                      f"{'; '.join(lines)}")

if __name__ == "__main__":
    main(sys.argv[1:] or DEFAULT)
