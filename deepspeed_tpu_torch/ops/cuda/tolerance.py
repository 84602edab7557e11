"""How a CUDA kernel's output is held against its plain version.

Both sides compute in fp32 from the same bf16 inputs and round to bf16
at the same points; they differ in summation order and, for attention,
in the max that p is taken against before it is rounded to bf16 (a
running max in the kernel, the row's final max in the plain version).
So an element may differ by a unit or two in bf16's last place (2**-8
of its size), and for the matvecs far more rarely than for attention.

An elementwise atol cannot hold all four kernels: paged-attention outputs
are ~0.02 in size while projection outputs reach ~4, so an atol that
admits the second admits an attention kernel that drops a page. The
check is relative, row by row: ``row_rel_err`` is the largest, over the
output's rows (its last dim), of ||got - want|| / ||want||. Each
kernel's limit (``ROW_RTOL``) sits between its own error and a planted
fault's, with room on both sides; ``chip_smoke.py`` prints all three at
the main path's shapes. On an H100 (chip_smoke.py, GPT-2 large widths)
the errors were 1.8e-4 (ln_qkv), 4.9e-6 (out_ffn), 4.6e-3 (paged
attention) and 4.8e-3 (flash), and the faults (the last 32 of 1280
weight rows, 64 rows of Wp, each slot's last page, the last 64-key tile)
0.16-0.99; one dropped weight row of 1280 would give about
sqrt(1/1280) = 0.03.
"""

import math

import torch

# largest row-relative error a kernel may show against its plain version
ROW_RTOL = {"ln_qkv_stacked": 2e-3, "out_ffn_stacked": 2e-3,
            "decode_attention_paged": 1e-2, "flash_attention_fwd": 1e-2}
# flash's lse is fp32 on both sides: only the summation order differs
LSE_ATOL = 1e-3


def row_rel_err(got, want):
    """max over rows of ||got - want|| / ||want||. A row that is zero in
    ``want`` must be exactly zero in ``got`` (error 0, else inf)."""
    g = got.detach().float().reshape(-1, got.shape[-1])
    w = want.detach().float().reshape(-1, want.shape[-1])
    if g.shape != w.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} vs "
                         f"{tuple(want.shape)}")
    if g.numel() == 0:
        return 0.0
    if not torch.isfinite(g).all():
        return math.inf
    num = (g - w).norm(dim=1)
    den = w.norm(dim=1)
    zero = torch.where(num > 0, math.inf, 0.0)
    rel = torch.where(den > 0, num / den.clamp_min(1e-30), zero)
    return float(rel.max())


def check_kernel(name, got, want):
    """Row-relative error of ``got`` against ``want``; raises
    AssertionError above ``ROW_RTOL[name]``."""
    err = row_rel_err(got, want)
    if not err <= ROW_RTOL[name]:
        raise AssertionError(f"{name}: row-relative error {err:.3g} > "
                             f"{ROW_RTOL[name]}")
    return err


def check_lse(got, want):
    """Largest absolute lse error; raises AssertionError above
    LSE_ATOL."""
    err = float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0
    if not err <= LSE_ATOL:
        raise AssertionError(f"flash_attention_fwd: lse error {err:.3g} > "
                             f"{LSE_ATOL}")
    return err
