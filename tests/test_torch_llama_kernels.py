"""deepspeed_tpu_torch decode and flash kernels on LLaMA's contract vs the
JAX Pallas kernels.

The plain versions (what a CPU tensor runs) are held against
``deepspeed_tpu.ops.pallas`` in interpret mode at fp32 on LLaMA's
variants: RMSNorm and bias-free projections, SwiGLU with both
``fuse_proj`` values, ``matvec_stacked``, head dim 128 with GQA query
rows. The CUDA kernels are held against the plain versions on the card
(``gpu`` marker). The matvec launches' shared-memory reckoning is checked
at GPT-2 large, LLaMA-7B (bf16 and int8 codes) and LLaMA-3-8B widths.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import builder, decode, tolerance
from deepspeed_tpu_torch.ops.cuda.decode import (
    decode_attention_paged, decode_attention_paged_plain, ln_qkv_stacked,
    ln_qkv_stacked_plain, matvec_smem, matvec_stacked, matvec_stacked_plain,
    out_ffn_stacked, out_ffn_stacked_plain)
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)
from torch_port_common import assert_close, cuda_device, t32  # noqa: F401

LAYER = 1


def _jax():
    """(jax.numpy, the Pallas decode module, the Pallas flash module),
    imported here so the gpu tests also run where JAX is not installed."""
    return (importlib.import_module("jax.numpy"),
            importlib.import_module("deepspeed_tpu.ops.pallas.decode"),
            importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention"))


def _w(rs, *shape, scale=0.05):
    return (scale * rs.randn(*shape)).astype(np.float32)


def _scales(rs, L):
    return (0.5 + rs.rand(L)).astype(np.float32)


# LLaMA's packed qkv at small width: E 128, 4 heads and 2 KV heads of 32
def _qkv_inputs(rs, B=3, E=128, N=256, L=3):
    return dict(x=rs.randn(B, E).astype(np.float32),
                ln_w=(1 + 0.1 * rs.randn(L, E)).astype(np.float32),
                w=_w(rs, L, E, N), s=_scales(rs, L))


def _ffn_inputs(rs, B=3, E=128, F=256, L=3):
    return dict(ctx=rs.randn(B, E).astype(np.float32),
                x=rs.randn(B, E).astype(np.float32),
                wp=_w(rs, L, E, E), sp=_scales(rs, L),
                ln_w=(1 + 0.1 * rs.randn(L, E)).astype(np.float32),
                wg=_w(rs, L, E, F), sg=_scales(rs, L),
                wu=_w(rs, L, E, F), su=_scales(rs, L),
                wd=_w(rs, L, F, E), sd=_scales(rs, L))


def _paged_inputs(rs, Lyr=2, NB=9, Hkv=2, P=16, D=128, B=3, R=4, MAXP=4):
    kp = (0.3 * rs.randn(Lyr, NB, Hkv, P, D)).astype(np.float32)
    vp = (0.3 * rs.randn(Lyr, NB, Hkv, P, D)).astype(np.float32)
    q = (0.3 * rs.randn(B, Hkv, R, D)).astype(np.float32)
    pt = np.zeros((B, MAXP), np.int32)           # tails point at trash
    pt[0, :2] = [5, 3]                           # scattered, out of order
    pt[1, :4] = [1, 8, 2, 7]
    pt[2, :1] = [6]
    pos = np.array([20, 58, -1], np.int32)       # slot 2 idle
    return q, kp, vp, pos, pt


# ------------------------------------------------ plain versions vs JAX

@pytest.mark.parametrize("B,N", [(3, 256), (8, 512)])
def test_ln_qkv_rms_plain_matches_pallas(B, N):
    jnp, jdec, _ = _jax()
    a = _qkv_inputs(np.random.RandomState(0), B=B, N=N)
    want = jdec.ln_qkv_int8_stacked(
        jnp.asarray(a["x"]), jnp.asarray(a["ln_w"]), None,
        jnp.asarray(a["w"]), jnp.asarray(a["s"]), None, LAYER, norm="rms")
    got = ln_qkv_stacked(t32(a["x"]), t32(a["ln_w"]), None, t32(a["w"]),
                         t32(a["s"]), None, LAYER, norm="rms")
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("fuse_proj", [True, False])
def test_out_ffn_swiglu_plain_matches_pallas(fuse_proj):
    jnp, jdec, _ = _jax()
    a = _ffn_inputs(np.random.RandomState(1))
    j = {k: jnp.asarray(v) for k, v in a.items()}
    want = jdec.out_ffn_int8_stacked(
        j["ctx"] if fuse_proj else None, j["x"],
        j["wp"] if fuse_proj else None, j["sp"] if fuse_proj else None,
        None, j["ln_w"], None, j["wg"], j["sg"], None, j["wd"], j["sd"],
        None, LAYER, act="swiglu", norm="rms", w1b_stack=j["wu"],
        s1b=j["su"], fuse_proj=fuse_proj)
    t = {k: t32(v) for k, v in a.items()}
    got = out_ffn_stacked(
        t["ctx"], t["x"], t["wp"], t["sp"], None, t["ln_w"], None, t["wg"],
        t["sg"], None, t["wd"], t["sd"], None, LAYER, act="swiglu",
        norm="rms", w1b_stack=t["wu"], s1b=t["su"], fuse_proj=fuse_proj)
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("B,K,N", [(3, 128, 128), (8, 256, 384)])
def test_matvec_stacked_plain_matches_pallas(B, K, N):
    jnp, jdec, _ = _jax()
    rs = np.random.RandomState(2)
    x, w, s = rs.randn(B, K).astype(np.float32), _w(rs, 3, K, N), \
        _scales(rs, 3)
    want = jdec.matvec_int8_stacked(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(s), LAYER)
    got = matvec_stacked(t32(x), t32(w), t32(s), LAYER)
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("R", [1, 4])
def test_paged_attention_d128_plain_matches_pallas(R):
    """Head dim 128 with R = H/Hkv query rows per KV head (GQA)."""
    jnp, jdec, _ = _jax()
    q, kp, vp, pos, pt = _paged_inputs(np.random.RandomState(3), R=R)
    want = np.asarray(jdec.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pos),
        jnp.asarray(pt), 1, scale=1.0 / math.sqrt(128)))
    got = decode_attention_paged(t32(q), t32(kp), t32(vp),
                                 torch.from_numpy(pos), torch.from_numpy(pt),
                                 1, scale=1.0 / math.sqrt(128))
    assert_close(got, want)
    assert torch.count_nonzero(got[2]) == 0 and not np.any(want[2])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_d128_gqa_plain_matches_pallas(causal):
    jnp, _, jfa = _jax()
    rs = np.random.RandomState(4)
    B, H, Hkv, S, D = 1, 4, 2, 64, 128
    q = rs.randn(B, H, S, D).astype(np.float32)
    k = rs.randn(B, Hkv, S, D).astype(np.float32)
    v = rs.randn(B, Hkv, S, D).astype(np.float32)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal)
    o, _ = flash_attention_fwd(t32(q), t32(k), t32(v), causal=causal)
    assert_close(o, np.asarray(want))


# ------------------------------------- the matvec launches' shared memory

# bytes a block of each launch needs (csrc/decode.cu matvec_smem with the
# launch's own K split), at 8 and 16 slots: (K, N, prologue, pair)
SMEM = {
    "gpt2_large": {
        ("ln_qkv", 1280, 3840, "ln_bf16", False): (46592, 90624),
        ("out_proj", 1280, 1280, "copy", False): (20992, 41984),
        ("up", 1280, 5120, "ln_f32", False): (74752, 144384),
        ("down", 5120, 1280, "copy", False): (28672, 57344)},
    "llama_7b": {
        ("ln_qkv", 4096, 12288, "rms_bf16", False): (165888, 315392),
        ("o_proj", 4096, 4096, "copy", False): (34816, 69632),
        ("gate/up", 4096, 11008, "rms_bf16", True): (165888, 315392),
        ("down", 11008, 4096, "copy", False): (62464, 124928)},
    # int8 codes: a 128-column tile (csrc/decode.cu WGeom<int8_t>)
    "llama_7b_int8": {
        ("ln_qkv", 4096, 12288, "rms_bf16", False): (143360, 278528),
        ("o_proj", 4096, 4096, "copy", False): (45056, 90112),
        ("gate/up", 4096, 11008, "rms_bf16", True): (184320, 352256),
        ("down", 11008, 4096, "copy", False): (58880, 117760)},
    "llama3_8b": {
        ("ln_qkv", 4096, 6144, "rms_bf16", False): (124928, 241664),
        ("o_proj", 4096, 4096, "copy", False): (34816, 69632),
        ("gate/up", 4096, 14336, "rms_bf16", True): (165888, 315392),
        ("down", 14336, 4096, "copy", False): (75776, 151552)},
}


@pytest.mark.parametrize("model", sorted(SMEM))
@pytest.mark.parametrize("slots", [8, 16])
def test_matvec_smem_follows_each_launch(model, slots):
    """Each launch is reckoned with its own K split, its column tile and
    the rows it stages, and exactly the launches over 227 KiB are
    refused."""
    i = 0 if slots == 8 else 1
    wbytes = 1 if model.endswith("int8") else 2
    for (what, K, N, prologue, pair), want in SMEM[model].items():
        got = matvec_smem(slots, K, N, prologue, pair, wbytes)
        assert got == want[i], (what, got, want[i])
        launch = [(what, K, N, prologue, pair)]
        if got > decode.MAX_SMEM:
            with pytest.raises(ValueError, match="shared memory"):
                decode._check_launches("t", slots, launch, wbytes)
        else:
            decode._check_launches("t", slots, launch, wbytes)
    # LLaMA serves 8 slots, bf16 or int8; at 16 its RMS-prologue launches
    # do not fit, GPT-2 large's all do
    over = [k[0] for k, v in SMEM[model].items() if v[i] > decode.MAX_SMEM]
    assert over == ([] if slots == 8 or model == "gpt2_large"
                    else ["ln_qkv", "gate/up"])


# ------------------------------------------ the limits the kernels meet

def _bf(*arrays):
    return [t32(a).to(torch.bfloat16) for a in arrays]


def _check_cases(key):
    """(plain version on bf16 inputs, an admissible result, a planted
    fault's result) for one LLaMA kernel variant at small widths: the
    matvecs summed over a permuted contraction axis, attention computed
    in fp32 and rounded once; the faults drop weight rows, a page or a
    key tile."""
    rs = np.random.RandomState(6)
    if key == "ln_qkv_stacked[rms]":
        a = _qkv_inputs(rs, B=4, E=512, N=256, L=2)
        (x, w), ln_w, s = _bf(a["x"], a["w"]), t32(a["ln_w"]), t32(a["s"])
        p = torch.from_numpy(rs.permutation(512))
        wf = w.clone()
        wf[1, -32:] = 0                         # 32 of 512 weight rows

        def run(x, ln_w, w):
            return ln_qkv_stacked_plain(x, ln_w, None, w, s, None, 1,
                                        norm="rms")
        return run(x, ln_w, w), run(x[:, p], ln_w[:, p], w[:, p]), \
            run(x, ln_w, wf)
    if key == "matvec_stacked":
        x, w = _bf(rs.randn(4, 512), _w(rs, 2, 512, 256))
        s = t32(_scales(rs, 2))
        p = torch.from_numpy(rs.permutation(512))
        wf = w.clone()
        wf[1, -32:] = 0
        return (matvec_stacked_plain(x, w, s, 1),
                matvec_stacked_plain(x[:, p], w[:, p], s, 1),
                matvec_stacked_plain(x, wf, s, 1))
    if key == "out_ffn_stacked[swiglu]":
        a = _ffn_inputs(rs, B=4, E=256, F=512, L=2)
        x, wg, wu, wd = _bf(a["x"], a["wg"], a["wu"], a["wd"])
        ln_w, sg, su, sd = (t32(a[k]) for k in ("ln_w", "sg", "su", "sd"))
        pe = torch.from_numpy(rs.permutation(256))
        pf = torch.from_numpy(rs.permutation(512))
        wdf = wd.clone()
        wdf[1, -32:] = 0                        # 32 of 512 rows of Wd

        def run(wg, wu, wd):
            return out_ffn_stacked_plain(
                None, x, None, None, None, ln_w, None, wg, sg, None, wd, sd,
                None, 1, act="swiglu", norm="rms", w1b_stack=wu, s1b=su,
                fuse_proj=False)
        return run(wg, wu, wd), \
            run(wg[..., pf], wu[..., pf], wd[:, pf]), run(wg, wu, wdf)
    if key == "decode_attention_paged[d128]":
        q, kp, vp, pos, pt = _paged_inputs(rs, R=4)
        q, kp, vp = _bf(q, kp, vp)
        pos, pt = torch.from_numpy(pos), torch.from_numpy(pt)
        pos_fault = torch.where(pos >= 16, pos // 16 * 16 - 1, pos)
        return (decode_attention_paged_plain(q, kp, vp, pos, pt, 1),
                decode_attention_paged_plain(q.float(), kp.float(),
                                             vp.float(), pos, pt, 1)
                .to(torch.bfloat16),
                decode_attention_paged_plain(q, kp, vp, pos_fault, pt, 1))
    q, k, v = _bf(rs.randn(1, 4, 256, 128), rs.randn(1, 2, 256, 128),
                  rs.randn(1, 2, 256, 128))
    o = flash_attention_fwd_plain(q, k, v)[0]
    return (o, flash_attention_fwd_plain(q.float(), k.float(), v.float())[0]
            .to(torch.bfloat16),
            flash_attention_fwd_plain(q, k[:, :, :-16], v[:, :, :-16])[0])


@pytest.mark.parametrize("key", ["ln_qkv_stacked[rms]", "matvec_stacked",
                                 "out_ffn_stacked[swiglu]",
                                 "decode_attention_paged[d128]",
                                 "flash_attention_fwd[d128]"])
def test_llama_kernel_limits_admit_rounding_and_reject_a_fault(key):
    want, admissible, fault = _check_cases(key)
    assert tolerance.check_kernel(key, admissible, want) >= 0
    with pytest.raises(AssertionError, match="row-relative error"):
        tolerance.check_kernel(key, fault, want)


# ------------------------------------------------------------ on the card

def _dev(a, dev, bf16=True):
    t = torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return t.to(torch.bfloat16) if bf16 else t


@pytest.mark.gpu
@pytest.mark.parametrize("B,E,N", [(8, 1024, 1536), (3, 512, 768)])
def test_cuda_ln_qkv_rms_matches_plain(cuda_device, B, E, N):
    a = _qkv_inputs(np.random.RandomState(7), B=B, E=E, N=N, L=3)
    dev = cuda_device
    x, w = _dev(a["x"], dev), _dev(a["w"], dev)
    ln_w, s = _dev(a["ln_w"], dev, False), _dev(a["s"], dev, False)
    n0 = builder.launches["ln_qkv_stacked"]
    got = ln_qkv_stacked(x, ln_w, None, w, s, None,
                         torch.tensor(LAYER, dtype=torch.int32, device=dev),
                         norm="rms")
    torch.cuda.synchronize()
    assert builder.launches["ln_qkv_stacked"] == n0 + 1
    tolerance.check_kernel("ln_qkv_stacked[rms]", got, ln_qkv_stacked_plain(
        x, ln_w, None, w, s, None, LAYER, norm="rms"))


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,N", [(8, 1024, 1024), (12, 2048, 512)])
def test_cuda_matvec_stacked_matches_plain(cuda_device, B, K, N):
    rs = np.random.RandomState(8)
    dev = cuda_device
    x, w = _dev(rs.randn(B, K), dev), _dev(_w(rs, 3, K, N), dev)
    s = _dev(_scales(rs, 3), dev, False)
    n0 = builder.launches["matvec_stacked"]
    got = matvec_stacked(x, w, s, torch.tensor(LAYER, dtype=torch.int32,
                                               device=dev))
    torch.cuda.synchronize()
    assert builder.launches["matvec_stacked"] == n0 + 1
    tolerance.check_kernel("matvec_stacked", got,
                           matvec_stacked_plain(x, w, s, LAYER))


@pytest.mark.gpu
@pytest.mark.parametrize("B,E,F", [(8, 1024, 2752), (5, 512, 1408)])
def test_cuda_out_ffn_swiglu_matches_plain(cuda_device, B, E, F):
    a = _ffn_inputs(np.random.RandomState(9), B=B, E=E, F=F)
    dev = cuda_device
    x, wg, wu, wd = (_dev(a[k], dev) for k in ("x", "wg", "wu", "wd"))
    ln_w, sg, su, sd = (_dev(a[k], dev, False)
                        for k in ("ln_w", "sg", "su", "sd"))
    args = (None, x, None, None, None, ln_w, None, wg, sg, None, wd, sd,
            None)
    kw = dict(act="swiglu", norm="rms", w1b_stack=wu, s1b=su,
              fuse_proj=False)
    n0 = builder.launches["out_ffn_stacked"]
    got = out_ffn_stacked(*args, torch.tensor(LAYER, dtype=torch.int32,
                                              device=dev), **kw)
    torch.cuda.synchronize()
    assert builder.launches["out_ffn_stacked"] == n0 + 1
    tolerance.check_kernel("out_ffn_stacked[swiglu]", got,
                           out_ffn_stacked_plain(*args, LAYER, **kw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out_ffn_stacked(*args, torch.tensor(LAYER, dtype=torch.int32,
                                            device=dev),
                        **dict(kw, fuse_proj=True))


@pytest.mark.gpu
@pytest.mark.parametrize("R,rows_per_step", [(1, None), (4, None), (4, 2)])
def test_cuda_paged_attention_d128_matches_plain(cuda_device, R,
                                                 rows_per_step):
    q, kp, vp, pos, pt = _paged_inputs(np.random.RandomState(10), R=R)
    dev = cuda_device
    args = (_dev(q, dev), _dev(kp, dev), _dev(vp, dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(pt).to(dev))
    n0 = builder.launches["decode_attention_paged"]
    got = decode_attention_paged(*args, torch.tensor(1, dtype=torch.int32,
                                                     device=dev),
                                 rows_per_step=rows_per_step)
    torch.cuda.synchronize()
    assert builder.launches["decode_attention_paged"] == n0 + 1
    assert torch.count_nonzero(got[2]) == 0
    tolerance.check_kernel("decode_attention_paged[d128]", got,
                           decode_attention_paged_plain(
                               *args, 1, rows_per_step=rows_per_step))


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,Hkv,causal", [(16, 8, 8, True),
                                             (300, 8, 2, True),
                                             (256, 4, 1, False)])
def test_cuda_flash_d128_matches_plain(cuda_device, S, H, Hkv, causal):
    rs = np.random.RandomState(11)
    dev = cuda_device
    q = _dev(rs.randn(1, H, S, 128), dev)
    k, v = (_dev(rs.randn(1, Hkv, S, 128), dev) for _ in range(2))
    n0 = builder.launches["flash_attention_fwd"]
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert builder.launches["flash_attention_fwd"] == n0 + 1
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=causal)
    tolerance.check_kernel("flash_attention_fwd[d128]", o, o_ref)
    tolerance.check_lse(lse, lse_ref)
