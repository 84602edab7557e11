"""deepspeed_tpu_torch decode kernels vs the JAX Pallas decode kernels.

Plain versions (what a CPU tensor runs) are held against
``deepspeed_tpu.ops.pallas.decode`` in interpret mode at fp32; the CUDA
kernels are held against the plain versions on the card at bf16.
"""

import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import builder, tolerance
from deepspeed_tpu_torch.ops.cuda.decode import (
    decode_attention_paged, decode_attention_paged_plain, ln_qkv_stacked,
    ln_qkv_stacked_plain, out_ffn_stacked, out_ffn_stacked_plain)
from torch_port_common import assert_close, cuda_device, t32  # noqa: F401

LAYER = 2


def _jax():
    """(jax.numpy, the Pallas decode module), imported here and not at
    the top so the gpu tests also run where JAX is not installed."""
    return (importlib.import_module("jax.numpy"),
            importlib.import_module("deepspeed_tpu.ops.pallas.decode"))


def _scales(rs, L):
    return (0.5 + rs.rand(L)).astype(np.float32)


def _qkv_inputs(rs, B=3, E=128, N=384, L=3):
    return dict(
        x=rs.randn(B, E).astype(np.float32),
        ln_w=(1 + 0.1 * rs.randn(L, 1, E)).astype(np.float32),
        ln_b=(0.1 * rs.randn(L, 1, E)).astype(np.float32),
        w=(0.05 * rs.randn(L, E, N)).astype(np.float32),
        s=_scales(rs, L),
        b=(0.1 * rs.randn(L, 1, N)).astype(np.float32))


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_ln_qkv_plain_matches_pallas(norm):
    jnp, jdec = _jax()
    a = _qkv_inputs(np.random.RandomState(0))
    rms = norm == "rms"
    want = jdec.ln_qkv_int8_stacked(
        jnp.asarray(a["x"]), jnp.asarray(a["ln_w"]),
        None if rms else jnp.asarray(a["ln_b"]), jnp.asarray(a["w"]),
        jnp.asarray(a["s"]), None if rms else jnp.asarray(a["b"]), LAYER,
        norm=norm)
    got = ln_qkv_stacked(t32(a["x"]), t32(a["ln_w"]), t32(a["ln_b"]),
                         t32(a["w"]), t32(a["s"]), t32(a["b"]), LAYER,
                         norm=norm)
    assert_close(got, np.asarray(want))


def _ffn_inputs(rs, B=3, E=128, F=256, L=3):
    def w(*shape):
        return (0.05 * rs.randn(*shape)).astype(np.float32)

    def vec(n):
        return (0.1 * rs.randn(L, 1, n)).astype(np.float32)
    return dict(ctx=rs.randn(B, E).astype(np.float32),
                x=rs.randn(B, E).astype(np.float32),
                wp=w(L, E, E), sp=_scales(rs, L), bp=vec(E),
                ln_w=(1 + vec(E)), ln_b=vec(E),
                w1=w(L, E, F), s1=_scales(rs, L), b1=vec(F),
                w2=w(L, F, E), s2=_scales(rs, L), b2=vec(E),
                w1b=w(L, E, F), s1b=_scales(rs, L))


@pytest.mark.parametrize("act,norm,fuse_proj", [
    ("gelu_tanh", "layer", True), ("gelu", "layer", True),
    ("swiglu", "rms", True), ("gelu_tanh", "layer", False)])
def test_out_ffn_plain_matches_pallas(act, norm, fuse_proj):
    jnp, jdec = _jax()
    a = _ffn_inputs(np.random.RandomState(1))
    rms, glu = norm == "rms", act == "swiglu"

    def j(k, drop=False):
        return None if drop else jnp.asarray(a[k])
    want = jdec.out_ffn_int8_stacked(
        j("ctx"), j("x"), j("wp"), j("sp"), j("bp", rms), j("ln_w"),
        j("ln_b", rms), j("w1"), j("s1"), j("b1", rms), j("w2"), j("s2"),
        j("b2", rms), LAYER, act=act, norm=norm,
        w1b_stack=j("w1b", not glu), s1b=j("s1b", not glu),
        fuse_proj=fuse_proj)
    got = out_ffn_stacked(
        *(t32(a[k]) for k in ("ctx", "x", "wp", "sp", "bp", "ln_w", "ln_b",
                              "w1", "s1", "b1", "w2", "s2", "b2")),
        LAYER, act=act, norm=norm,
        w1b_stack=t32(a["w1b"]) if glu else None,
        s1b=t32(a["s1b"]) if glu else None, fuse_proj=fuse_proj)
    assert_close(got, np.asarray(want))


def _paged_inputs(rs, Lyr=2, NB=9, H=4, P=16, D=64, B=3, R=2, MAXP=4):
    kp = (0.3 * rs.randn(Lyr, NB, H, P, D)).astype(np.float32)
    vp = (0.3 * rs.randn(Lyr, NB, H, P, D)).astype(np.float32)
    q = (0.3 * rs.randn(B, H, R, D)).astype(np.float32)
    pt = np.zeros((B, MAXP), np.int32)           # tails point at trash
    pt[0, :2] = [5, 3]                           # scattered, out of order
    pt[1, :4] = [1, 8, 2, 7]
    pt[2, :1] = [6]
    pos = np.array([20, 58, -1], np.int32)       # slot 2 idle
    return q, kp, vp, pos, pt


@pytest.mark.parametrize("rows_per_step", [None, 1])
def test_paged_attention_plain_matches_pallas(rows_per_step):
    jnp, jdec = _jax()
    q, kp, vp, pos, pt = _paged_inputs(np.random.RandomState(2))
    want = np.asarray(jdec.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pos),
        jnp.asarray(pt), 1, rows_per_step=rows_per_step))
    got = decode_attention_paged(t32(q), t32(kp), t32(vp),
                                 torch.from_numpy(pos), torch.from_numpy(pt),
                                 1, rows_per_step=rows_per_step)
    assert_close(got, want)
    # idle slot: exact zeros, on both sides
    assert torch.count_nonzero(got[2]) == 0
    assert not np.any(want[2])


def _kernel_check_cases(name):
    """(plain version on bf16 inputs, an admissible kernel result, the
    plain version with a planted fault) for one decode kernel at small
    widths. The matvecs round where their plain versions do, so what a
    kernel may differ in is the summation order: the same product over a
    permuted contraction axis. Attention also rounds p against another
    max: the plain version on the fp32 values, rounded to bf16 once."""
    bf = torch.bfloat16
    rs = np.random.RandomState(6)
    if name == "ln_qkv_stacked":
        a = _qkv_inputs(rs, B=4, E=512, N=256, L=2)
        x, ln_w, ln_b, w = (t32(a[k]) for k in ("x", "ln_w", "ln_b", "w"))
        x, w = x.to(bf), w.to(bf)
        s, b = t32(a["s"]), t32(a["b"])
        perm = torch.from_numpy(rs.permutation(512))
        w_fault = w.clone()
        w_fault[1, -32:] = 0                   # 32 of 512 weight rows
        return (ln_qkv_stacked_plain(x, ln_w, ln_b, w, s, b, 1),
                ln_qkv_stacked_plain(x[:, perm], ln_w[..., perm],
                                     ln_b[..., perm], w[:, perm], s, b, 1),
                ln_qkv_stacked_plain(x, ln_w, ln_b, w_fault, s, b, 1))
    if name == "out_ffn_stacked":
        a = _ffn_inputs(rs, B=4, E=256, F=512, L=2)
        keys = ("ctx", "x", "wp", "sp", "bp", "ln_w", "ln_b", "w1", "s1",
                "b1", "w2", "s2", "b2")
        big = {"ctx", "x", "wp", "w1", "w2"}
        v = {k: t32(a[k]).to(bf) if k in big else t32(a[k]) for k in keys}
        pe = torch.from_numpy(rs.permutation(256))
        pf = torch.from_numpy(rs.permutation(512))
        perm = dict(v, ctx=v["ctx"][:, pe], wp=v["wp"][:, pe],
                    w1=v["w1"][..., pf], b1=v["b1"][..., pf],
                    w2=v["w2"][:, pf])
        fault = dict(v, wp=v["wp"].clone())
        fault["wp"][1, -16:] = 0               # 16 of 256 rows of Wp
        return tuple(out_ffn_stacked_plain(*(d[k] for k in keys), 1)
                     for d in (v, perm, fault))
    q, kp, vp, pos, pt = _paged_inputs(rs, R=1)
    q, kp, vp = (t32(t).to(bf) for t in (q, kp, vp))
    pos, pt = torch.from_numpy(pos), torch.from_numpy(pt)
    pos_fault = torch.where(pos >= 16, pos // 16 * 16 - 1, pos)  # last page
    return (decode_attention_paged_plain(q, kp, vp, pos, pt, 1),
            decode_attention_paged_plain(q.float(), kp.float(), vp.float(),
                                         pos, pt, 1).to(bf),
            decode_attention_paged_plain(q, kp, vp, pos_fault, pt, 1))


@pytest.mark.parametrize("name", ["ln_qkv_stacked", "out_ffn_stacked",
                                  "decode_attention_paged"])
def test_kernel_check_admits_rounding_and_rejects_a_fault(name):
    """The limit a CUDA kernel is held to on the card admits a result
    summed (and, for attention, rounded) in another order and rejects
    one missing a slice of its keys or weight rows."""
    want, admissible, fault = _kernel_check_cases(name)
    assert tolerance.check_kernel(name, admissible, want) >= 0
    with pytest.raises(AssertionError, match="row-relative error"):
        tolerance.check_kernel(name, fault, want)


def test_row_rel_err_zero_rows_and_non_finite():
    want = torch.zeros(2, 4)
    want[0] = 1.0
    assert tolerance.row_rel_err(want, want) == 0.0
    got = want.clone()
    got[1, 0] = 1e-6                          # the zero row must stay zero
    assert tolerance.row_rel_err(got, want) == float("inf")
    got = want.clone()
    got[0, 0] = float("nan")
    assert tolerance.row_rel_err(got, want) == float("inf")


# ------------------------------------------------------------ on the card

def _bf16(a, dev):
    return torch.from_numpy(np.asarray(a)).to(dev, torch.bfloat16)


def _f32(a, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


# GPT-2 large at 8 slots (the main path), and GPT-2 small widths at 12
# slots (the 16-row accumulator and a different K split)
WIDTHS = [(8, 1280), (12, 768)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,E", WIDTHS)
def test_cuda_ln_qkv_matches_plain(cuda_device, B, E):
    a = _qkv_inputs(np.random.RandomState(3), B=B, E=E, N=3 * E, L=4)
    dev = cuda_device
    args = (_bf16(a["x"], dev), _f32(a["ln_w"], dev), _f32(a["ln_b"], dev),
            _bf16(a["w"], dev), _f32(a["s"], dev), _f32(a["b"], dev))
    layer = torch.tensor(LAYER, dtype=torch.int32, device=dev)
    n0 = builder.launches["ln_qkv_stacked"]
    got = ln_qkv_stacked(*args, layer)
    torch.cuda.synchronize()
    assert builder.launches["ln_qkv_stacked"] == n0 + 1
    tolerance.check_kernel("ln_qkv_stacked", got,
                           ln_qkv_stacked_plain(*args, LAYER))
    with pytest.raises(ValueError, match="int32 tensor"):
        ln_qkv_stacked(*args, LAYER)              # a host int: not taken


@pytest.mark.gpu
@pytest.mark.parametrize("B,E", WIDTHS)
def test_cuda_out_ffn_matches_plain(cuda_device, B, E):
    a = _ffn_inputs(np.random.RandomState(4), B=B, E=E, F=4 * E, L=3)
    dev = cuda_device
    mats = {"ctx", "x", "wp", "w1", "w2"}
    args = [(_bf16 if k in mats else _f32)(a[k], dev)
            for k in ("ctx", "x", "wp", "sp", "bp", "ln_w", "ln_b", "w1",
                      "s1", "b1", "w2", "s2", "b2")]
    layer = torch.tensor(LAYER, dtype=torch.int32, device=dev)
    n0 = builder.launches["out_ffn_stacked"]
    got = out_ffn_stacked(*args, layer)
    torch.cuda.synchronize()
    assert builder.launches["out_ffn_stacked"] == n0 + 1
    tolerance.check_kernel("out_ffn_stacked", got,
                           out_ffn_stacked_plain(*args, LAYER))
    with pytest.raises(NotImplementedError):
        out_ffn_stacked(*args, layer, act="gelu")


@pytest.mark.gpu
@pytest.mark.parametrize("R,rows_per_step,P", [(1, None, 16), (2, 1, 16),
                                               (4, 2, 16), (1, None, 128)])
def test_cuda_paged_attention_matches_plain(cuda_device, R, rows_per_step,
                                            P):
    q, kp, vp, pos, pt = _paged_inputs(np.random.RandomState(5), R=R, P=P)
    dev = cuda_device
    args = (_bf16(q, dev), _bf16(kp, dev), _bf16(vp, dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(pt).to(dev))
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    n0 = builder.launches["decode_attention_paged"]
    got = decode_attention_paged(*args, layer, rows_per_step=rows_per_step)
    torch.cuda.synchronize()
    assert builder.launches["decode_attention_paged"] == n0 + 1
    assert torch.count_nonzero(got[2]) == 0
    tolerance.check_kernel("decode_attention_paged", got,
                           decode_attention_paged_plain(
                               *args, 1, rows_per_step=rows_per_step))
