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

LLaMA's variants have limits of their own (``kernel[variant]``). On an
H100 at LLaMA-7B widths (chip_smoke.py, 8 slots) the errors were 6.9e-5
(RMSNorm ln_qkv), 4.2e-5 (matvec_stacked), 3.9e-4 (SwiGLU out_ffn),
4.0e-3 (paged attention at head dim 128, R 1 and R 4) and 4.4e-3 (flash
forward at head dim 128), and their faults (the last 32 of 4096 weight
rows, the last 32 of 11008 rows of the down projection, each slot's last
page, the last 64-key tile) 0.10, 0.11, 0.024, 0.55 and 0.96: the
limits keep the GPT-2 kernels' values, 5-30x above the errors and 12-275x
below the faults.

The int8 variants (``kernel[int8]``; chip_smoke.py at LLaMA-7B widths, 8
slots, on an H100) showed 6.2e-6 (ln_qkv), 1.3e-6 (matvec_stacked),
2.4e-4 (SwiGLU out_ffn), 4.0e-3 (paged attention over the int8 pool, R 1
and R 4) and 4.2e-3 / 3.9e-3 (stacked attention over an int8 / a bf16
cache of 8 rows at ctx 2048), against faults of 0.11, 0.099, 0.027,
0.69 and 0.16 / 0.14: the same limits hold, 13-1500x above the errors
and 3-70x below the faults. ``kv_quant_int8`` is held bit for bit (limit
0): its codes truncated instead of rounded gave 0.024.

GPT-2's int8 contract and the unstacked kernels (chip_smoke.py at GPT-2
large widths, B 1 and 8, on an H100) showed 1.8e-4 (ln_qkv_stacked),
8.9e-5 (out_ffn_stacked), 4.5e-3 (paged attention over an int8 pool at
head dim 64), 2.7e-6 (ln_qkv_int8), 0 (out_ffn_int8, every output equal
after rounding), 2.4e-7 (matvec_int8) and 4.5e-3 (decode_attention_int8
and the stacked form at head dim 64, ctx 2048, the scales past pos NaN),
against faults of 0.17, 0.15, 0.64, 0.15, 0.13, 0.15 and 0.18 / 0.25:
the family limits hold, 2.2-8000x above the errors and 18-85x below the
faults.

The flash backward's gradients have rows whose true value is ~0 by
cancellation, not by construction: in a causal dq, query 0 sees only key
0, so p = 1 and ds = dp - delta is rounding noise on both sides. Their
check measures each row against at least ``ROW_FLOOR[name]`` times the
tensor's root-mean-square row norm, which leaves every other row's
relative error as it is. On an H100 (chip_smoke.py, B=8, H=20, S=1024
causal, S=8192 causal and S=1024 not causal) the earlier pair of
backward kernels showed 6.1e-3 (dk/dv) and 5.1e-3 (dq), and their faults
(the last 64-query tile's contribution dropped from dk/dv, the first
64-key tile from dq) 1.10 and 1.13: the limit 2e-2 sits 3x above the one
and 55x below the other. The single-pass kernel that replaced them
(``flash_attention_bwd``: dq, dk and dv) is held to the same limit and
floor: on an H100 its errors were 4.3e-3-5.2e-3 at head dims 64 and 128
and its faults (the last 64-row q tile out of dk/dv, the first 128-key
tile out of dq) 0.85-1.08.

``flash_attention_bwd_delta`` (rowsum(do·o) in fp32) differs from its
plain version only in the order of its fp32 sums: on an H100 its
row-relative error (a row is one head's S values) was 7.5e-8 to 9.3e-8;
one row's value dropped gives about 1/sqrt(S) (0.011 at S 8192), so
the limit 1e-4 sits ~1000x above the one and ~100x below the other.
"""

import math

import torch

# largest row-relative error a kernel may show against its plain version;
# "name[variant]" is the limit of one variant of a kernel (LLaMA's
# RMSNorm, SwiGLU and head dim 128), set from that variant's own error
ROW_RTOL = {"ln_qkv_stacked": 2e-3, "out_ffn_stacked": 2e-3,
            "decode_attention_paged": 1e-2, "flash_attention_fwd": 1e-2,
            "flash_attention_bwd": 2e-2, "flash_attention_bwd_delta": 1e-4,
            "matvec_stacked": 2e-3, "ln_qkv_stacked[rms]": 2e-3,
            "out_ffn_stacked[swiglu]": 2e-3,
            "decode_attention_paged[d128]": 1e-2,
            "flash_attention_fwd[d128]": 1e-2,
            "ln_qkv_stacked[int8]": 2e-3, "matvec_stacked[int8]": 2e-3,
            "out_ffn_stacked[swiglu,int8]": 2e-3,
            "decode_attention_paged[int8]": 1e-2,
            "decode_attention_stacked": 1e-2,
            "decode_attention_stacked[int8]": 1e-2,
            "kv_quant_int8": 0.0,
            # what the attention kernel's folded append writes into the
            # cache (int8 codes and scales, or the bf16 rows): bit for bit
            "kv_append": 0.0,
            # GPT-2's int8 contract (LayerNorm, biases, gelu_tanh, fused
            # o-projection), the int8 cache at head dim 64, and the
            # unstacked kernels, which run the stacked kernels' code
            "ln_qkv_stacked[ln,int8]": 2e-3, "out_ffn_stacked[int8]": 2e-3,
            "decode_attention_stacked[int8,d64]": 1e-2,
            "decode_attention_paged[int8,d64]": 1e-2,
            "matvec_int8": 2e-3, "ln_qkv_int8": 2e-3, "out_ffn_int8": 2e-3,
            "decode_attention_int8": 1e-2,
            # block-sparse attention: the flash kernels' limits
            "blocksparse_fwd": 1e-2, "blocksparse_bwd_dq": 2e-2,
            "blocksparse_bwd_dkv": 2e-2,
            # grouped fake quantization: bit for bit (every operation an
            # IEEE one rounded to nearest on both sides)
            "quantize": 0.0,
            # the fused collective GEMMs: fp32 sums of exact bf16 products
            # in another order (bf16 outputs may round a unit apart); the
            # reduce adds the same fp32 values in the same order
            "ag_matmul": 5e-3, "ag_matmul[fp32]": 1e-4,
            "mm_rs_partial": 1e-4, "mm_rs_reduce": 0.0}
# least row norm, as a share of the RMS row norm, an error is measured on
ROW_FLOOR = {"flash_attention_bwd": 1e-3,
             "blocksparse_bwd_dq": 1e-3, "blocksparse_bwd_dkv": 1e-3}
# flash's lse is fp32 on both sides: only the summation order differs
LSE_ATOL = 1e-3


def row_rel_err(got, want, floor=0.0):
    """max over rows of ||got - want|| / max(||want||, floor · RMS row
    norm of ``want``). With no floor, a row that is zero in ``want``
    must be exactly zero in ``got`` (error 0, else inf)."""
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
    if floor:
        den = den.clamp_min(floor * float(den.square().mean().sqrt()))
    zero = torch.where(num > 0, math.inf, 0.0)
    rel = torch.where(den > 0, num / den.clamp_min(1e-30), zero)
    return float(rel.max())


def kernel_err(name, got, want):
    """Row-relative error of ``got`` against ``want`` as ``name``'s check
    measures it."""
    return row_rel_err(got, want, ROW_FLOOR.get(name, 0.0))


def check_kernel(name, got, want):
    """Row-relative error of ``got`` against ``want``; raises
    AssertionError above ``ROW_RTOL[name]``."""
    err = kernel_err(name, got, want)
    if not err <= ROW_RTOL[name]:
        raise AssertionError(f"{name}: row-relative error {err:.3g} > "
                             f"{ROW_RTOL[name]}")
    return err


def check_lse(got, want, name="flash_attention_fwd"):
    """Largest absolute lse error; raises AssertionError above
    LSE_ATOL."""
    err = float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0
    if not err <= LSE_ATOL:
        raise AssertionError(f"{name}: lse error {err:.3g} > {LSE_ATOL}")
    return err
