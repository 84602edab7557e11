"""deepspeed_tpu_torch decode kernels vs the JAX Pallas decode kernels.

Plain versions (what a CPU tensor runs) are held against
``deepspeed_tpu.ops.pallas.decode`` in interpret mode at fp32; the CUDA
kernels are held against the plain versions on the card at bf16.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import builder, tolerance
from deepspeed_tpu_torch.ops.cuda import decode as dk
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


# ----------------------------------- the attention kernel's split plan

# (B, KV heads, capacity): GPT-2 large's fast route b1 and b8 at ctx 2048,
# its paged serving (8 slots, 64 pages of 16), LLaMA-7B's fast path b1
# and b8 and its paged serving, LLaMA-3-8B's GQA heads, and many slots
PLAN_CASES = [(1, 20, 2048), (8, 20, 2048), (8, 20, 1024), (1, 32, 2048),
              (8, 32, 2048), (8, 32, 1024), (8, 8, 2048), (64, 32, 4096),
              (3, 2, 128), (1, 1, 16), (1, 1, 32768)]


@pytest.mark.parametrize("B,H,cap", PLAN_CASES)
@pytest.mark.parametrize("sms", [132, 114])
def test_decode_split_plan_covers_the_capacity(B, H, cap, sms):
    plan = dk.decode_split_plan(B, H, cap, sms)
    assert plan.chunk % dk.PAGE_MULTIPLE == 0 and plan.chunk > 0
    assert plan.n_split * plan.chunk >= cap > (plan.n_split - 1) * plan.chunk
    assert plan.grid == (H, B, plan.n_split)
    assert plan.n_split <= dk.ATTN_MAX_SPLITS
    blocks = dk.ATTN_BLOCKS_PER_SM * sms
    if B * H >= dk.ATTN_SPLIT_BELOW * sms:
        assert plan.n_split == 1          # enough blocks without a split
        return
    # the blocks an SM (unless the splits are single groups), and not
    # many more
    want = math.ceil(blocks / (B * H))
    want = min(want, dk.ATTN_MAX_SPLITS)
    assert plan.n_split >= want or plan.chunk == dk.PAGE_MULTIPLE \
        or -(-cap // (plan.chunk - dk.PAGE_MULTIPLE)) > dk.ATTN_MAX_SPLITS
    assert plan.n_split <= want + want // 4 + 1
    # even: the last split is no shorter than a group under the others
    assert cap - (plan.n_split - 1) * plan.chunk > \
        plan.chunk - plan.n_split * dk.PAGE_MULTIPLE


def test_decode_split_plan_never_reads_pos():
    """The plan is a function of the shapes and the card: its arguments
    hold no position, so a decode loop can replay one launch as pos
    moves."""
    import inspect
    assert list(inspect.signature(dk.decode_split_plan).parameters) == \
        ["B", "H", "capacity", "sms"]
    assert dk.decode_split_plan(1, 20, 2048) == (8, 256, (20, 1, 8))
    assert dk.decode_split_plan(8, 32, 2048) == (1, 2048, (32, 8, 1))
    assert dk.decode_split_plan(8, 20, 1024) == (2, 512, (20, 8, 2))
    assert dk.decode_split_plan(8, 40, 1024).n_split == 1


# the capacity and chunk of the split model's tests: splits of 32 keys
# (two stages of 16-key groups in the last), pos at the boundaries
SPLIT_CAP, SPLIT_CHUNK = 128, 48
SPLIT_POS = [0, 15, 16, 47, 48, 49, 95, 96, 127]


def _stacked_inputs(rs, int8, R, Lyr=2, B=2, Hkv=2, D=64):
    q = (0.3 * rs.randn(B, Hkv, R, D)).astype(np.float32)
    shape = (Lyr, B, Hkv, SPLIT_CAP, D)
    if int8:
        kc, vc = (rs.randint(-127, 128, shape).astype(np.int8)
                  for _ in range(2))
        ks, vs = ((0.5 + rs.rand(Lyr, B, Hkv, 1, SPLIT_CAP)).astype(
            np.float32) * 0.01 for _ in range(2))
        return q, kc, vc, ks, vs
    kc, vc = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    return q, kc, vc, None, None


@pytest.mark.parametrize("pos", SPLIT_POS)
@pytest.mark.parametrize("int8,R,D", [(False, 1, 64), (False, 4, 64),
                                      (True, 2, 64), (False, 1, 128),
                                      (True, 1, 128)])
def test_split_model_matches_pallas_stacked(pos, int8, R, D):
    """The kernel's split-and-merge order, in plain PyTorch, against
    decode_attention_fp_stacked / decode_attention_int8_stacked in
    interpret mode at fp32: pos at 0, a page's last key, split
    boundaries +-1 and the capacity's last key."""
    jnp, jdec = _jax()
    q, kc, vc, ks, vs = _stacked_inputs(np.random.RandomState(pos), int8, R,
                                        D=D)
    if int8:
        want = jdec.decode_attention_int8_stacked(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(ks), jnp.asarray(vc),
            jnp.asarray(vs), pos, 1)
        got = dk.decode_attention_stacked_splits(
            t32(q), torch.from_numpy(kc), torch.from_numpy(vc), pos, 1,
            SPLIT_CHUNK, t32(ks), t32(vs))
    else:
        want = jdec.decode_attention_fp_stacked(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), pos, 1)
        got = dk.decode_attention_stacked_splits(t32(q), t32(kc), t32(vc),
                                                 pos, 1, SPLIT_CHUNK)
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("rows_per_step,int8", [(None, False), (1, False),
                                                (None, True)])
def test_split_model_matches_pallas_paged(rows_per_step, int8):
    """The same against decode_attention_paged: scattered pages, slots at
    split boundaries +-1 and the last key, an idle slot, a multi-query
    window."""
    jnp, jdec = _jax()
    rs = np.random.RandomState(7)
    Lyr, NB, H, P, D, R, MAXP = 2, 12, 2, 16, 64, 2, 8
    pos = np.array([0, 47, 48, 49, 125, -1, 15, 16], np.int32)
    B = len(pos)
    pt = rs.randint(1, NB, (B, MAXP)).astype(np.int32)
    q = (0.3 * rs.randn(B, H, R, D)).astype(np.float32)
    pools = [(0.3 * rs.randn(Lyr, NB, H, P, D)).astype(np.float32)
             for _ in range(2)]
    sc = {}
    if int8:
        pools = [rs.randint(-127, 128, p.shape).astype(np.int8)
                 for p in pools]
        sc = {n: (0.5 + rs.rand(Lyr, NB, H, 1, P)).astype(np.float32) * 0.01
              for n in ("k_scale", "v_scale")}
    want = np.asarray(jdec.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(pos), jnp.asarray(pt), 1, rows_per_step=rows_per_step,
        **{n: jnp.asarray(v) for n, v in sc.items()}))
    got = dk.decode_attention_paged_splits(
        t32(q), *(torch.from_numpy(p) for p in pools), torch.from_numpy(pos),
        torch.from_numpy(pt), 1, SPLIT_CHUNK, rows_per_step=rows_per_step,
        **{n: t32(v) for n, v in sc.items()})
    assert_close(got, want)
    assert torch.count_nonzero(got[5]) == 0      # the idle slot


# ------------------------------------- the folded cache append (new_k)

def _jax_append_stacked(caches, k3, v3, pos, layer):
    """The JAX fast loops' append (``models/llama_inference.py:290-301``):
    kv_quant_int8's codes and scales into an int8 cache, the rows into an
    fp one, by dynamic_update_slice at (layer, 0, 0, pos), which clamps
    pos to L - 1."""
    jax = importlib.import_module("jax")
    jnp, jdec = _jax()
    dus = jax.lax.dynamic_update_slice
    B, H, _ = k3.shape
    k3, v3 = jnp.asarray(k3), jnp.asarray(v3)
    if len(caches) == 4:
        kc, ks, vc, vs = map(jnp.asarray, caches)
        kq, ksc, vq, vsc = jdec.kv_quant_int8(k3, v3)
        return (dus(kc, kq[None, :, :, None, :], (layer, 0, 0, pos, 0)),
                dus(ks, ksc.reshape(1, B, H, 1, 1), (layer, 0, 0, 0, pos)),
                dus(vc, vq[None, :, :, None, :], (layer, 0, 0, pos, 0)),
                dus(vs, vsc.reshape(1, B, H, 1, 1), (layer, 0, 0, 0, pos)))
    kc, vc = map(jnp.asarray, caches)
    return (dus(kc, k3[None, :, :, None, :], (layer, 0, 0, pos, 0)),
            dus(vc, v3[None, :, :, None, :], (layer, 0, 0, pos, 0)))


@pytest.mark.parametrize("pos", [5, SPLIT_CAP - 1, SPLIT_CAP,
                                 SPLIT_CAP + 3])
@pytest.mark.parametrize("int8,R,D", [(False, 1, 64), (True, 1, 64),
                                      (False, 4, 128), (True, 4, 128)])
def test_folded_append_stacked_matches_jax(pos, int8, R, D):
    """decode_attention_stacked with new_k/new_v: the cache it leaves
    equals the JAX loop's append (kv_quant_int8 + dynamic_update_slice,
    bit for bit; at pos >= L the write lands on row L - 1) and the port's
    two separate calls (kv_quant_int8 or the rows' copy, then the
    attention), and its output equals the JAX attention over that cache
    at 2e-5 and the separate calls' bit for bit."""
    jnp, jdec = _jax()
    rs = np.random.RandomState(100 + pos)
    q, kc, vc, ks, vs = _stacked_inputs(rs, int8, R, D=D)
    B, Hkv = q.shape[:2]
    k3, v3 = (rs.randn(B, Hkv, D).astype(np.float32) for _ in range(2))
    caches = (kc, ks, vc, vs) if int8 else (kc, vc)
    want_caches = _jax_append_stacked(caches, k3, v3, pos, 1)
    if int8:
        want = jdec.decode_attention_int8_stacked(
            jnp.asarray(q), want_caches[0], want_caches[1], want_caches[2],
            want_caches[3], pos, 1)
    else:
        want = jdec.decode_attention_fp_stacked(
            jnp.asarray(q), want_caches[0], want_caches[1], pos, 1)
    got_caches = [torch.from_numpy(c.copy()) for c in caches]
    sc = dict(k_scale=got_caches[1], v_scale=got_caches[3]) if int8 else {}
    kk, vv = got_caches[0], got_caches[len(caches) // 2]
    pos_t = torch.tensor([pos], dtype=torch.int32)
    got = dk.decode_attention_stacked(t32(q), kk, vv, pos_t, 1,
                                      new_k=t32(k3), new_v=t32(v3), **sc)
    for g, w in zip(got_caches, want_caches):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert_close(got, np.asarray(want))
    # the separate calls the fold replaces
    sep = [torch.from_numpy(c.copy()) for c in caches]
    row = torch.tensor([min(pos, SPLIT_CAP - 1)], dtype=torch.int32)
    if int8:
        dk.kv_quant_int8(t32(k3), t32(v3), out=tuple(sep), layer=1, rows=row)
        sc = dict(k_scale=sep[1], v_scale=sep[3])
    else:
        sep[0][1].index_copy_(2, row.long(), t32(k3)[:, :, None])
        sep[1][1].index_copy_(2, row.long(), t32(v3)[:, :, None])
    alone = dk.decode_attention_stacked(t32(q), sep[0], sep[len(sep) // 2],
                                        pos_t, 1, **sc)
    assert all(torch.equal(a, b) for a, b in zip(sep, got_caches))
    assert torch.equal(alone, got)


@pytest.mark.parametrize("int8,R,D", [(False, 2, 64), (True, 1, 64),
                                      (True, 4, 128)])
def test_folded_append_paged_matches_jax(int8, R, D):
    """decode_attention_paged with new_k/new_v over scattered pages: each
    live slot's row lands where the JAX adapter's ``_append_rows`` puts
    it (block page_table[b, pos // page], row pos % page; codes and
    scales bit for bit), the output equals the JAX paged attention over
    that pool at 2e-5, and the idle slot (pos -1) writes nothing: JAX
    writes its row into the trash block 0, which the port leaves as it
    was (no test reads the trash block's contents)."""
    jax = importlib.import_module("jax")
    jnp, jdec = _jax()
    from deepspeed_tpu.serving.adapters import _append_rows, _gather_blocks
    rs = np.random.RandomState(21)
    q, kp, vp, pos, pt = _paged_inputs(rs, R=R, D=D, H=2)
    B, H = q.shape[:2]
    pos = np.array([31, 16, -1], np.int32)       # a page's last row, first
    pt[2] = 0                   # an idle slot's table is all trash
    k3, v3 = (rs.randn(B, H, D).astype(np.float32) for _ in range(2))
    pool = (kp, vp)
    sc = {}
    if int8:
        pool = (rs.randint(-127, 128, kp.shape).astype(np.int8),
                (0.5 + rs.rand(*kp.shape[:3], 1, kp.shape[3])).astype(
                    np.float32) * 0.01,
                rs.randint(-127, 128, vp.shape).astype(np.int8),
                (0.5 + rs.rand(*vp.shape[:3], 1, vp.shape[3])).astype(
                    np.float32) * 0.01)
    blk, rows = _gather_blocks(jnp.asarray(pt), jnp.asarray(pos), 16)
    want_pool = _append_rows(tuple(map(jnp.asarray, pool)), int8, 1, blk,
                             rows, jnp.asarray(k3), jnp.asarray(v3))
    jsc = dict(k_scale=want_pool[1], v_scale=want_pool[3]) if int8 else {}
    want = jdec.decode_attention_paged(
        jnp.asarray(q), want_pool[0], want_pool[len(pool) // 2],
        jnp.asarray(pos), jnp.asarray(pt), 1, **jsc)
    got_pool = [torch.from_numpy(p.copy()) for p in pool]
    if int8:
        sc = dict(k_scale=got_pool[1], v_scale=got_pool[3])
    got = decode_attention_paged(
        t32(q), got_pool[0], got_pool[len(pool) // 2],
        torch.from_numpy(pos), torch.from_numpy(pt), 1, new_k=t32(k3),
        new_v=t32(v3), **sc)
    assert_close(got, np.asarray(want))
    assert torch.count_nonzero(got[2]) == 0
    for g, w, before in zip(got_pool, want_pool, pool):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy()[:, 1:], w[:, 1:])
        np.testing.assert_array_equal(g.numpy()[:, 0], before[:, 0])
    assert not np.array_equal(np.asarray(want_pool[0])[:, 0], pool[0][:, 0])
    if R > 1:
        with pytest.raises(NotImplementedError, match="one new row a slot"):
            decode_attention_paged(
                t32(q), got_pool[0], got_pool[len(pool) // 2],
                torch.from_numpy(pos), torch.from_numpy(pt), 1,
                new_k=t32(k3), new_v=t32(v3), rows_per_step=1, **sc)
    with pytest.raises(ValueError, match="both new_k and new_v"):
        decode_attention_paged(t32(q), got_pool[0], got_pool[len(pool) // 2],
                               torch.from_numpy(pos), torch.from_numpy(pt),
                               1, new_k=t32(k3), **sc)


def test_folded_append_one_layer_int8_matches_the_separate_calls():
    """decode_attention_int8 (the per-token layer's one-layer cache) with
    new_k/new_v writes kv_quant_int8's codes and scales at min(pos, L -
    1), as the step wrote them before with its own call, and attends
    over them."""
    rs = np.random.RandomState(31)
    B, H, L, D = 2, 3, 32, 64
    q = t32(0.3 * rs.randn(B, H, 1, D))
    k3, v3 = (t32(rs.randn(B, H, D)) for _ in range(2))
    for pos in (7, L - 1, L + 2):
        kc, vc = (torch.from_numpy(rs.randint(-127, 128, (B, H, L, D))
                                   .astype(np.int8)) for _ in range(2))
        ks, vs = (t32((0.5 + rs.rand(B, H, L)) * 0.01) for _ in range(2))
        sep = [t.clone() for t in (kc, ks, vc, vs)]
        p = torch.tensor([pos], dtype=torch.int32)
        got = dk.decode_attention_int8(q, kc, ks, vc, vs, p, new_k=k3,
                                       new_v=v3)
        row = torch.tensor([min(pos, L - 1)], dtype=torch.int32)
        dk.kv_quant_int8(k3, v3, out=(sep[0][None], sep[1][None, :, :, None],
                                      sep[2][None], sep[3][None, :, :, None]),
                         rows=row)
        want = dk.decode_attention_int8(q, *sep, p)
        assert all(torch.equal(a, b) for a, b in zip((kc, ks, vc, vs), sep))
        assert torch.equal(got, want)


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


def _sweep(cap, plan):
    """pos 0, a page's last key and the next, each split boundary +-1 and
    the capacity's last key."""
    ps = {0, 15, 16, cap - 1}
    for s in range(1, plan.n_split):
        ps |= {s * plan.chunk - 1, s * plan.chunk, s * plan.chunk + 1}
    return sorted(p for p in ps if 0 <= p < cap)


# (B, KV heads, R, D, capacity): GPT-2 large's fast route (b1, 20 heads)
# and LLaMA-7B's (b8, 32 heads) at ctx 2048; LLaMA-3-8B's GQA rows
SWEEP_SHAPES = [(1, 20, 1, 64, 2048), (1, 32, 1, 128, 2048),
                (8, 32, 1, 128, 2048), (2, 8, 4, 128, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,R,D,L", SWEEP_SHAPES)
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_stacked_attention_pos_sweep(cuda_device, B, H, R, D, L, int8):
    """decode_attention_stacked at pos on every split boundary +-1, a
    page's edge and the last key, against the plain version; the int8
    cache's scales past pos are NaN and must not reach the result; a
    rerun is bit-equal."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(11)
    shape = (2, B, H, L, D)
    q = torch.randn(B, H, R, D, generator=g, device=dev).to(torch.bfloat16)
    if int8:
        kc, vc = (torch.randint(-127, 128, shape, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        sc = [torch.rand(shape[:3] + (1, L), generator=g, device=dev) * 0.01
              + 0.002 for _ in range(2)]
    else:
        kc, vc = (torch.randn(shape, generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dk.decode_split_plan(B, H, L, sms)
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    name = "decode_attention_stacked" + ("[int8]" if int8 else "")
    for p in _sweep(L, plan):
        kw = {}
        if int8:
            k_s, v_s = (s.clone() for s in sc)
            k_s[..., p + 1:] = float("nan")
            v_s[..., p + 1:] = float("nan")
            kw = dict(k_scale=k_s, v_scale=v_s)
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        n0 = builder.launches["decode_attention_stacked"]
        got = dk.decode_attention_stacked(q, kc, vc, pos, layer, **kw)
        again = dk.decode_attention_stacked(q, kc, vc, pos, layer, **kw)
        torch.cuda.synchronize()
        assert builder.launches["decode_attention_stacked"] == n0 + 2
        assert torch.isfinite(got).all(), p
        assert torch.equal(got, again), p
        tolerance.check_kernel(name, got, dk.decode_attention_stacked_plain(
            q, kc, vc, pos, 1, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("D,int8,R,rows_per_step", [
    (64, False, 1, None), (128, False, 4, None), (64, True, 1, None),
    (128, True, 4, 1), (64, False, 4, 2)])
def test_cuda_paged_attention_pos_sweep(cuda_device, D, int8, R,
                                        rows_per_step):
    """decode_attention_paged over 64 scattered pages of 16 a slot (GPT-2
    serving's pool) with slots at every split boundary +-1, the last key
    and idle, against the plain version, rerun bit-equal."""
    dev = cuda_device
    rs = np.random.RandomState(12)
    H, P, MAXP, Lyr = 4, 16, 64, 2
    cap = MAXP * P
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pos_list = _sweep(cap, dk.decode_split_plan(16, H, cap, sms)) + [-1]
    B = len(pos_list)
    NB = B * MAXP + 1
    pt = torch.from_numpy(rs.permutation(np.arange(1, NB))[:B * MAXP]
                          .reshape(B, MAXP).astype(np.int32)).to(dev)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn(B, H, R, D, generator=g, device=dev).to(torch.bfloat16)
    shape = (Lyr, NB, H, P, D)
    kw = {}
    if int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        kw = {n: torch.rand(shape[:3] + (1, P), generator=g, device=dev)
              * 0.01 + 0.002 for n in ("k_scale", "v_scale")}
    else:
        kp, vp = (torch.randn(shape, generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
    layer = torch.tensor(1, dtype=torch.int32, device=dev)
    got = decode_attention_paged(q, kp, vp, pos, pt, layer,
                                 rows_per_step=rows_per_step, **kw)
    again = decode_attention_paged(q, kp, vp, pos, pt, layer,
                                   rows_per_step=rows_per_step, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.count_nonzero(got[-1]) == 0
    name = "decode_attention_paged" + ("[int8]" if int8 else "")
    tolerance.check_kernel(name, got, decode_attention_paged_plain(
        q, kp, vp, pos, pt, 1, rows_per_step=rows_per_step, **kw))


# (D, KV heads, R, int8): GPT-2 large's heads, LLaMA-7B's, LLaMA-3-8B's
# GQA rows, over both caches
FOLD_CASES = [(64, 20, 1, True), (128, 32, 1, True), (128, 8, 4, True),
              (64, 20, 1, False), (128, 8, 4, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("D,H,R,int8", FOLD_CASES)
def test_cuda_folded_append_matches_the_separate_calls(cuda_device, paged,
                                                       D, H, R, int8):
    """The attention kernel with new_k/new_v against the two launches it
    replaces on the same inputs (kv_quant_int8 into the cache, or the
    rows' copy, then the attention): the caches bit for bit (an int8
    cache's codes and scales also equal kv_quant_int8_plain's at the
    written row), the output bit for bit, kv_quant_int8 never launched by
    the fold. The new rows are views with their own batch strides, as the
    decode paths pass them. Stacked: pos at a page's edge, a split
    boundary, the last row and past the end (the write clamps to L - 1).
    Paged: scattered pages, an idle slot (the fold writes nothing; the
    separate call wrote into the trash block)."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(17)
    L, Lyr, layer_i = 1024, 2, 1
    layer = torch.tensor(layer_i, dtype=torch.int32, device=dev)

    def rows(B):
        """K from the RoPE'd [B, R H + H, D] rows, V a column slice of the
        packed qkv [B, (R + 2) H D], as LLaMA's tick passes them (their
        batch strides differ)."""
        qk = torch.randn(B, R * H + H, D, generator=g, device=dev) \
            .to(torch.bfloat16)
        qkv = torch.randn(B, (R + 2) * H * D, generator=g, device=dev) \
            .to(torch.bfloat16)
        return qk[:, R * H:], qkv[:, (R + 1) * H * D:].view(B, H, D)

    def cache(shape, sshape):
        if int8:
            return [torch.randint(-127, 128, shape, generator=g, device=dev,
                                  dtype=torch.int8),
                    torch.rand(sshape, generator=g, device=dev) * 0.01 + 2e-3,
                    torch.randint(-127, 128, shape, generator=g, device=dev,
                                  dtype=torch.int8),
                    torch.rand(sshape, generator=g, device=dev) * 0.01 + 2e-3]
        return [torch.randn(shape, generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2)]

    def call(c, q, pos, extra, **fold):
        sc = dict(k_scale=c[1], v_scale=c[3]) if int8 else {}
        if paged:
            return dk.decode_attention_paged(q, c[0], c[len(c) // 2], pos,
                                             extra, layer, **sc, **fold)
        return dk.decode_attention_stacked(q, c[0], c[len(c) // 2], pos,
                                           layer, **sc, **fold)

    if paged:
        P, MAXP = 16, 64
        pos_list = [17, 16, 1023, 512, -1, 0, 255, 900]
        B = len(pos_list)
        NB = B * MAXP + 1
        rs = np.random.RandomState(3)
        pt = torch.from_numpy(rs.permutation(np.arange(1, NB))[:B * MAXP]
                              .reshape(B, MAXP).astype(np.int32)).to(dev)
        pt[4] = 0                               # the idle slot: all trash
        cases = [(torch.tensor(pos_list, dtype=torch.int32, device=dev),
                  pt)]
        shape, sshape = (Lyr, NB, H, P, D), (Lyr, NB, H, 1, P)
    else:
        B = 2 if R > 1 else 8
        cases = [(torch.tensor([p], dtype=torch.int32, device=dev), None)
                 for p in (15, 16, 511, L - 1, L + 3)]
        shape, sshape = (Lyr, B, H, L, D), (Lyr, B, H, 1, L)
    for pos, pt in cases:
        q = torch.randn(B, H, R, D, generator=g, device=dev) \
            .to(torch.bfloat16)
        k3, v3 = rows(B)
        base = cache(shape, sshape)
        sep = [t.clone() for t in base]
        fold = [t.clone() for t in base]
        if paged:
            live = pos >= 0
            p = pos.long().clamp(min=0)
            blk = pt.gather(1, torch.clamp(p // 16, max=MAXP - 1)[:, None]
                            )[:, 0].int()
            row = (p % 16).int()
            blk = torch.where(live, blk, torch.zeros_like(blk))
            if int8:
                dk.kv_quant_int8(k3, v3, out=tuple(sep), layer=layer,
                                 blocks=blk, rows=row)
            else:
                sep[0][layer_i][blk.long(), :, row.long()] = k3
                sep[1][layer_i][blk.long(), :, row.long()] = v3
        else:
            row = pos.clamp(max=L - 1)
            if int8:
                dk.kv_quant_int8(k3, v3, out=tuple(sep), layer=layer,
                                 rows=row)
            else:
                sep[0][layer_i].index_copy_(2, row.long(), k3[:, :, None])
                sep[1][layer_i].index_copy_(2, row.long(), v3[:, :, None])
        want = call(sep, q, pos, pt)
        n0 = dict(builder.launches)
        got = call(fold, q, pos, pt, new_k=k3, new_v=v3)
        torch.cuda.synchronize()
        grew = {n: c - n0.get(n, 0) for n, c in builder.launches.items()
                if c != n0.get(n, 0)}
        assert grew == {"decode_attention_" +
                        ("paged" if paged else "stacked"): 1}, grew
        if paged:
            # the separate call wrote the idle slot's row into the trash
            # block, which the fold leaves alone
            for s, f, b in zip(sep, fold, base):
                s[:, 0] = b[:, 0]
                assert torch.equal(f[:, 0], b[:, 0])
        for s, f in zip(sep, fold):
            assert torch.equal(s, f), (pos.tolist(), s.dtype)
        assert torch.equal(got, want), pos.tolist()
        if int8:
            kq, ks, vq, vs = dk.kv_quant_int8_plain(k3, v3)
            live = (pos >= 0).nonzero()[:, 0] if paged else \
                torch.arange(B, device=dev)
            for b in live.tolist():
                bb, r = (int(blk[b]), int(row[b])) if paged else \
                    (b, int(row))
                assert torch.equal(fold[0][layer_i, bb, :, r], kq[b])
                assert torch.equal(fold[2][layer_i, bb, :, r], vq[b])
                assert torch.equal(fold[1][layer_i, bb, :, 0, r], ks[b, :, 0])
                assert torch.equal(fold[3][layer_i, bb, :, 0, r], vs[b, :, 0])
