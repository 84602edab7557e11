"""deepspeed_tpu_torch block-sparse attention vs the JAX package.

The sparsity configs' layouts (equal bit for bit under one
``np.random.seed``) and their messages, the layout tables against
``_layout_tables``, the kernels' plain versions (what a CPU tensor runs)
against the Pallas kernels in interpret mode at fp32, the masked-dense
dispatch, ``SparseSelfAttention`` and the utils. On the card, each CUDA
kernel against its plain version with a planted fault the same check
must reject.
"""

import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import blocksparse as bs
from deepspeed_tpu_torch.ops.cuda import builder, tolerance
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention, sparse_attention)
from torch_port_common import assert_close, cuda_device, t32  # noqa: F401


def _jax(name):
    """A module of jax or of the JAX package, imported here and not at the
    top so the gpu tests also run where JAX is not installed."""
    return importlib.import_module(name)


def _jsc():
    return _jax("deepspeed_tpu.ops.sparse_attention.sparsity_config")


# (config class name, kwargs, seq_len): every mode, per-head patterns,
# unidirectional and horizontal globals, index ranges, random blocks
LAYOUTS = [
    ("DenseSparsityConfig", dict(num_heads=2, block=16), 64),
    ("FixedSparsityConfig", dict(num_heads=4, block=16,
                                 different_layout_per_head=True,
                                 num_local_blocks=4, num_global_blocks=1,
                                 num_different_global_patterns=4), 256),
    ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=3,
                                 attention="unidirectional"), 160),
    ("FixedSparsityConfig", dict(num_heads=2, block=32, num_local_blocks=4,
                                 num_global_blocks=2,
                                 horizontal_global_attention=True), 320),
    ("VariableSparsityConfig", dict(num_heads=3, block=16,
                                    different_layout_per_head=True,
                                    num_random_blocks=2,
                                    local_window_blocks=[2, 3],
                                    global_block_indices=[0, -1]), 224),
    ("VariableSparsityConfig", dict(num_heads=2, block=16,
                                    num_random_blocks=1,
                                    global_block_indices=[1, 5],
                                    global_block_end_indices=[3, 7],
                                    attention="unidirectional"), 192),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16,
                                   different_layout_per_head=True,
                                   num_random_blocks=2,
                                   num_sliding_window_blocks=3,
                                   num_global_blocks=1), 256),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16,
                                        num_sliding_window_blocks=5,
                                        global_block_indices=[0, 4]), 192),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16,
                                        global_block_indices=[2],
                                        global_block_end_indices=[4]), 128),
]


@pytest.mark.parametrize("name,kw,S", LAYOUTS)
def test_layouts_match_jax_bit_for_bit(name, kw, S):
    np.random.seed(123)
    want = getattr(_jsc(), name)(**kw).make_layout(S)
    np.random.seed(123)
    got = getattr(tsc, name)(**kw).make_layout(S)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw,S", [
    ("FixedSparsityConfig", dict(num_heads=1, num_local_blocks=4,
                                 num_global_blocks=3), 64),
    ("FixedSparsityConfig", dict(num_heads=1, attention="causal"), 64),
    ("FixedSparsityConfig", dict(num_heads=1, attention="unidirectional",
                                 horizontal_global_attention=True), 64),
    ("FixedSparsityConfig", dict(num_heads=2,
                                 num_different_global_patterns=2), 64),
    ("FixedSparsityConfig", dict(num_heads=2, different_layout_per_head=True,
                                 num_different_global_patterns=5), 64),
    ("VariableSparsityConfig", dict(num_heads=1, global_block_indices=[0, 2],
                                    global_block_end_indices=[1]), 64),
    ("VariableSparsityConfig", dict(num_heads=1, global_block_indices=[3],
                                    global_block_end_indices=[3]), 64),
    ("VariableSparsityConfig", dict(num_heads=1, num_random_blocks=9), 64),
    ("BigBirdSparsityConfig", dict(num_heads=1, num_sliding_window_blocks=9),
     64),
    ("BSLongformerSparsityConfig", dict(num_heads=1,
                                        num_sliding_window_blocks=9), 64),
    ("BSLongformerSparsityConfig", dict(num_heads=1, global_block_indices=[2],
                                        global_block_end_indices=[1]), 64),
    ("DenseSparsityConfig", dict(num_heads=1), 100),
])
def test_config_errors_carry_the_jax_messages(name, kw, S):
    with pytest.raises((ValueError, NotImplementedError)) as want:
        getattr(_jsc(), name)(**kw).make_layout(S)
    with pytest.raises((ValueError, NotImplementedError)) as got:
        getattr(tsc, name)(**kw).make_layout(S)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


SA_BLOCKS = [
    {"mode": "dense", "block": 16},
    {"mode": "fixed", "block": 16, "different_layout_per_head": True,
     "num_local_blocks": 4, "num_global_blocks": 1,
     "attention": "bidirectional", "horizontal_global_attention": False,
     "num_different_global_patterns": 4},
    {"mode": "variable", "block": 16, "num_random_blocks": 1,
     "local_window_blocks": [2, 4], "global_block_indices": [0]},
    {"mode": "bigbird", "block": 16, "num_random_blocks": 1},
    {"mode": "bslongformer", "block": 16, "global_block_indices": [1],
     "global_block_end_indices": [3]},
    {},
]


@pytest.mark.parametrize("block", SA_BLOCKS)
def test_config_to_sparsity_matches_jax(block):
    from deepspeed_tpu_torch.config.config import SparseAttentionConfig
    jcfg = _jax("deepspeed_tpu.config.config").SparseAttentionConfig(
        {"sparse_attention": block})
    tcfg = SparseAttentionConfig({"sparse_attention": block})
    assert vars(tcfg) == vars(jcfg)
    np.random.seed(7)
    want = _jsc().config_to_sparsity(jcfg, 4).make_layout(256)
    np.random.seed(7)
    got = tsc.config_to_sparsity(tcfg, 4).make_layout(256)
    np.testing.assert_array_equal(got, want)
    absent = SparseAttentionConfig({})
    assert not absent.enabled and tcfg.enabled


def test_config_to_sparsity_unknown_mode_message():
    from deepspeed_tpu_torch.config.config import SparseAttentionConfig
    pd = {"sparse_attention": {"mode": "strided"}}
    with pytest.raises(NotImplementedError) as want:
        _jsc().config_to_sparsity(
            _jax("deepspeed_tpu.config.config").SparseAttentionConfig(pd), 2)
    with pytest.raises(NotImplementedError) as got:
        tsc.config_to_sparsity(SparseAttentionConfig(pd), 2)
    assert str(got.value) == str(want.value)


def _layout(i, S):
    """LAYOUTS[i]'s layout at S, drawn after np.random.seed(0)."""
    name, kw, _ = LAYOUTS[i]
    np.random.seed(0)
    return getattr(tsc, name)(**kw).make_layout(S)


def _empty_rows_layout():
    """Rows 1 and 3 of 4 attend to nothing; column 3 is attended by none."""
    layout = np.zeros((1, 4, 4), np.int64)
    layout[0, 0, 0] = 1
    layout[0, 2, :3] = 1
    return layout


@pytest.mark.parametrize("layout", [_layout(1, 256), _layout(6, 256),
                                    _empty_rows_layout()[0][None],
                                    np.ones((2, 3, 3), np.int64)])
def test_layout_tables_match_jax(layout):
    jbs = _jax("deepspeed_tpu.ops.pallas.blocksparse")
    counts, cols = bs._tables(layout)
    want_c, want_cols, width = jbs._layout_tables(layout)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(cols, want_cols)
    assert cols.dtype == np.int32 and cols.shape[-1] == width


def test_layout_tables_collapse_and_cache():
    """Equal heads collapse to one table (blocksparse.py:487-494); the
    tables are made once per layout object and sequence length."""
    shared = tsc.FixedSparsityConfig(num_heads=4, block=16).make_layout(128)
    per_head = _layout(1, 256)
    t1 = bs.layout_tables(shared, 128, 16, 4, "cpu")
    assert t1.heads == 1 and t1 is bs.layout_tables(shared, 128, 16, 4, "cpu")
    assert bs.layout_tables(shared, 64, 16, 4, "cpu").num_blocks == 4
    assert bs.layout_tables(per_head, 256, 16, 4, "cpu").heads == 4
    with pytest.raises(ValueError, match="does not cover"):
        bs.layout_tables(per_head, 256, 16, 2, "cpu")


def _qkv(B, H, S, D, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, S, D).astype(np.float32) for _ in range(3)]


# (layout, block, B, H, S, D): per-head tables, a shared BigBird layout
# (collapsed to one table), block 32, empty rows and an unattended column
KERNEL_CASES = [
    ("fixed4", 16, 1, 4, 128, 16),
    ("bigbird_shared", 16, 2, 2, 96, 32),
    ("fixed_b32", 32, 1, 2, 320, 16),
    ("empty_rows", 16, 1, 1, 64, 16),
]


def _case_layout(kind):
    np.random.seed(0)
    if kind == "fixed4":
        return _layout(1, 128)
    if kind == "bigbird_shared":
        return tsc.BigBirdSparsityConfig(num_heads=2, block=16,
                                         num_random_blocks=1).make_layout(96)
    if kind == "fixed_b32":
        return _layout(3, 320)
    return _empty_rows_layout()


def _jax_tables(layout, H):
    """The ungrouped tables tuple _bs_fwd/_bs_bwd take."""
    jnp = _jax("jax.numpy")
    jbs = _jax("deepspeed_tpu.ops.pallas.blocksparse")
    lay = np.broadcast_to(layout, (H,) + layout.shape[1:])
    if np.all(lay == lay[:1]):
        lay = lay[:1]
    c, cols, m = jbs._layout_tables(lay)
    ct, rows, mt = jbs._layout_tables(lay.transpose(0, 2, 1))
    return (jnp.asarray(c), jnp.asarray(cols), m, jnp.asarray(ct),
            jnp.asarray(rows), mt, H, lay.shape[0], None, 1)


@pytest.mark.parametrize("kind,block,B,H,S,D", KERNEL_CASES)
def test_plain_versions_match_pallas(kind, block, B, H, S, D):
    """The plain forward's o and lse against ``_bs_fwd`` in interpret mode
    (fp32, 2e-5); dq, dk, dv through the autograd Function against
    ``jax.vjp`` of ``blocksparse_attention`` (rtol 2e-4, atol 2e-5, the
    JAX suite's own); rows with no block give lse +1e30 and zero grads."""
    jax = _jax("jax")
    jnp = _jax("jax.numpy")
    jbs = _jax("deepspeed_tpu.ops.pallas.blocksparse")
    layout = _case_layout(kind)
    q, k, v = _qkv(B, H, S, D)
    do = np.random.RandomState(1).randn(B, H, S, D).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    flat = [jnp.asarray(a.reshape(B * H, S, D)) for a in (q, k, v)]
    o_j, lse_j = jbs._bs_fwd(*flat, _jax_tables(layout, H), scale, block,
                             True)
    out_j, vjp = jax.vjp(lambda q, k, v: jbs.blocksparse_attention(
        q, k, v, layout, block, interpret=True), q, k, v)
    grads_j = vjp(jnp.asarray(do))

    tables = bs.layout_tables(layout, S, block, H, "cpu")
    o, lse = bs.blocksparse_fwd(*(t32(a.reshape(B * H, S, D))
                                  for a in (q, k, v)), tables, scale)
    assert_close(o, np.asarray(o_j))
    assert_close(lse, np.asarray(lse_j)[..., 0])
    tq, tk, tv = (t32(a).requires_grad_() for a in (q, k, v))
    out = bs.blocksparse_attention(tq, tk, tv, layout, block)
    assert_close(out, np.asarray(out_j))
    out.backward(t32(do))
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        assert_close(got, np.asarray(want), atol=2e-5, rtol=2e-4)
    if kind == "empty_rows":
        for rows in (slice(16, 32), slice(48, 64)):
            assert bool((lse[0, rows] == bs.POS_INF).all())
            assert not out[0, 0, rows].any()
            assert not tq.grad[0, 0, rows].any()
        assert not tk.grad[0, 0, 48:].any() and not tv.grad[0, 0, 48:].any()


@pytest.mark.parametrize("masks", ["key_padding", "attn", "both"])
def test_masked_dense_dispatch_matches_jax(masks):
    """A mask selects the masked-dense path on both sides (counted as
    sparse_attention_dense); use_kernel=True with a mask raises, as
    blocksparse.py:469-470 does."""
    jnp = _jax("jax.numpy")
    jssa = _jax("deepspeed_tpu.ops.sparse_attention.sparse_self_attention")
    B, H, S, D = 2, 2, 64, 16
    layout = _case_layout("empty_rows")
    q, k, v = _qkv(B, H, S, D)
    rs = np.random.RandomState(3)
    kpm = (rs.rand(B, S) > 0.3) if masks != "attn" else None
    am = (rs.rand(S, S) > 0.2) if masks != "key_padding" else None
    want = jssa.sparse_attention(
        *(jnp.asarray(a) for a in (q, k, v)), layout, 16,
        key_padding_mask=None if kpm is None else jnp.asarray(kpm),
        attn_mask=None if am is None else jnp.asarray(am), use_kernel=False)
    n0 = builder.launches["sparse_attention_dense"]
    got = sparse_attention(
        *(t32(a) for a in (q, k, v)), layout, 16,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
        attn_mask=None if am is None else torch.from_numpy(am))
    assert builder.launches["sparse_attention_dense"] == n0 + 1
    assert_close(got, np.asarray(want))
    with pytest.raises(NotImplementedError, match="dense fallback"):
        sparse_attention(*(t32(a) for a in (q, k, v)), layout, 16,
                         key_padding_mask=torch.ones(B, S, dtype=torch.bool),
                         use_kernel=True)


def test_dense_path_and_kernel_path_agree_without_masks():
    q, k, v = (t32(a) for a in _qkv(1, 4, 128, 16))
    layout = _case_layout("fixed4")
    got = sparse_attention(q, k, v, layout, 16)
    want = sparse_attention(q, k, v, layout, 16, use_kernel=False)
    assert_close(got, want)


def test_sparse_self_attention_module_matches_jax():
    """The module keeps one layout per sequence length (a random layout
    is drawn once) and gives JAX's module output on the same layout."""
    jnp = _jax("jax.numpy")
    jmod = _jax("deepspeed_tpu.ops.sparse_attention").SparseSelfAttention
    kw = dict(num_heads=2, block=16, num_random_blocks=1)
    jop = jmod(_jsc().BigBirdSparsityConfig(**kw))
    top = SparseSelfAttention(tsc.BigBirdSparsityConfig(**kw))
    q, k, v = _qkv(2, 2, 96, 16)
    np.random.seed(5)
    want = jop(*(jnp.asarray(a) for a in (q, k, v)))
    np.random.seed(5)
    got = top(*(t32(a) for a in (q, k, v)))
    assert_close(got, np.asarray(want))
    assert top.get_layout(96) is top.get_layout(96)
    np.testing.assert_array_equal(top.get_layout(96), jop.get_layout(96))


def _drop_last(tables, line, transposed=False):
    """The tables with the last listed block of row (or, transposed,
    column) ``line`` of table 0 left out: a planted fault."""
    counts = (tables.counts_t if transposed else tables.counts).clone()
    counts[0, line] -= 1
    if transposed:
        return bs.LayoutTables(tables.counts, tables.cols, counts,
                               tables.rows_t, tables.block)
    return bs.LayoutTables(counts, tables.cols, tables.counts_t,
                           tables.rows_t, tables.block)


def test_kernel_limits_admit_rounding_and_reject_a_dropped_block():
    """The limits the CUDA kernels are held to on the card admit the
    plain versions in bf16 against fp32 and reject a k-block left out of
    one row (forward, dq) or a q-block out of one column (dk/dv)."""
    B, H, S, D = 1, 4, 256, 64
    layout = _layout(1, S)
    tables = bs.layout_tables(layout, S, 16, H, "cpu")
    bf = [t32(a).reshape(B * H, S, D).to(torch.bfloat16)
          for a in _qkv(B, H, S, D) + _qkv(B, H, S, D, seed=1)[:1]]
    q, k, v, do = (t.float() for t in bf)
    o32, lse32 = bs.blocksparse_fwd_plain(q, k, v, tables)
    delta = (do * o32).sum(-1)
    o, lse = bs.blocksparse_fwd_plain(*bf[:3], tables)
    row, col = 4, 5       # head 0: 7 blocks in row 4, 4 in column 5
    fault_o = bs.blocksparse_fwd_plain(q, k, v, _drop_last(tables, row))[0]
    assert tolerance.check_kernel("blocksparse_fwd", o, o32) > 0
    tolerance.check_lse(lse, lse32, "blocksparse_fwd")
    with pytest.raises(AssertionError, match="row-relative"):
        tolerance.check_kernel("blocksparse_fwd", fault_o, o32)
    dq32 = bs.blocksparse_bwd_dq_plain(q, k, v, do, lse32, delta, tables)
    dq = bs.blocksparse_bwd_dq_plain(*bf, lse32, delta, tables)
    fault_dq = bs.blocksparse_bwd_dq_plain(q, k, v, do, lse32, delta,
                                           _drop_last(tables, row))
    tolerance.check_kernel("blocksparse_bwd_dq", dq, dq32)
    with pytest.raises(AssertionError, match="row-relative"):
        tolerance.check_kernel("blocksparse_bwd_dq", fault_dq, dq32)
    dkv32 = bs.blocksparse_bwd_dkv_plain(q, k, v, do, lse32, delta, tables)
    dkv = bs.blocksparse_bwd_dkv_plain(*bf, lse32, delta, tables)
    fault = bs.blocksparse_bwd_dkv_plain(q, k, v, do, lse32, delta,
                                         _drop_last(tables, col, True))
    for got, f, want in zip(dkv, fault, dkv32):
        tolerance.check_kernel("blocksparse_bwd_dkv", got, want)
        with pytest.raises(AssertionError, match="row-relative"):
            tolerance.check_kernel("blocksparse_bwd_dkv", f, want)


# -- on the card --------------------------------------------------------------

GPU_CASES = [  # (layout kind, block, B, H, S)
    ("fixed_per_head", 16, 2, 16, 1024),
    ("bigbird_shared", 32, 1, 4, 512),
    ("bigbird_shared", 64, 1, 4, 1024),
    ("bigbird_shared", 128, 1, 2, 1024),
    ("empty_rows", 16, 1, 2, 64),
]


def _gpu_layout(kind, block, H, S):
    np.random.seed(0)
    if kind == "fixed_per_head":
        return tsc.FixedSparsityConfig(
            num_heads=H, block=block, different_layout_per_head=True,
            num_local_blocks=4, num_different_global_patterns=4
        ).make_layout(S)
    if kind == "bigbird_shared":
        return tsc.BigBirdSparsityConfig(
            num_heads=H, block=block, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1).make_layout(S)
    return _empty_rows_layout()


@pytest.mark.gpu
@pytest.mark.parametrize("kind,block,B,H,S", GPU_CASES)
def test_cuda_kernels_match_plain(cuda_device, kind, block, B, H, S):
    layout = _gpu_layout(kind, block, H, S)
    tables = bs.layout_tables(layout, S, block, H, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(B * H, S, 64, generator=gen,
                               device=cuda_device).to(torch.bfloat16)
                   for _ in range(4))
    n0 = dict(builder.launches)
    o, lse = bs.blocksparse_fwd(q, k, v, tables)
    o_p, lse_p = bs.blocksparse_fwd_plain(q, k, v, tables)
    delta = (do.float() * o_p).sum(-1)
    dq = bs.blocksparse_bwd_dq(q, k, v, do, lse_p, delta, tables)
    dk, dv = bs.blocksparse_bwd_dkv(q, k, v, do, lse_p, delta, tables)
    torch.cuda.synchronize()
    for name in ("blocksparse_fwd", "blocksparse_bwd_dq",
                 "blocksparse_bwd_dkv"):
        assert builder.launches[name] == n0.get(name, 0) + 1
    tolerance.check_kernel("blocksparse_fwd", o, o_p)
    tolerance.check_lse(lse, lse_p, "blocksparse_fwd")
    tolerance.check_kernel(
        "blocksparse_bwd_dq", dq,
        bs.blocksparse_bwd_dq_plain(q, k, v, do, lse_p, delta, tables))
    for got, want in zip((dk, dv), bs.blocksparse_bwd_dkv_plain(
            q, k, v, do, lse_p, delta, tables)):
        tolerance.check_kernel("blocksparse_bwd_dkv", got, want)
    if kind != "empty_rows":     # planted faults: one block left out
        row, col = (int(torch.nonzero(c == c[c > 1].min())[0])
                    for c in (tables.counts[0], tables.counts_t[0]))
        args = (q, k, v, do, lse_p, delta)
        faults = [
            ("blocksparse_fwd", o_p, bs.blocksparse_fwd_plain(
                q, k, v, _drop_last(tables, row))[0]),
            ("blocksparse_bwd_dq",
             bs.blocksparse_bwd_dq_plain(*args, tables),
             bs.blocksparse_bwd_dq_plain(*args, _drop_last(tables, row)))]
        for want, fault in zip(
                bs.blocksparse_bwd_dkv_plain(*args, tables),
                bs.blocksparse_bwd_dkv_plain(*args,
                                             _drop_last(tables, col, True))):
            faults.append(("blocksparse_bwd_dkv", want, fault))
        for name, want, fault in faults:
            with pytest.raises(AssertionError, match="row-relative"):
                tolerance.check_kernel(name, fault, want)


@pytest.mark.gpu
def test_cuda_training_through_the_function(cuda_device):
    """blocksparse_attention under autograd on the card runs the three
    kernels once each and gives the plain versions' gradients."""
    B, H, S = 1, 4, 256
    layout = _gpu_layout("fixed_per_head", 16, H, S)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn(B, H, S, 64, generator=gen,
                               device=cuda_device).to(torch.bfloat16)
                   for _ in range(4))
    n0 = dict(builder.launches)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = sparse_attention(qg, kg, vg, layout, 16)
    out.backward(do)
    torch.cuda.synchronize()
    for name in ("blocksparse_fwd", "blocksparse_bwd_dq",
                 "blocksparse_bwd_dkv"):
        assert builder.launches[name] == n0.get(name, 0) + 1
    assert builder.launches["sparse_attention_dense"] == \
        n0.get("sparse_attention_dense", 0)
    assert out.dtype == torch.bfloat16
    tables = bs.layout_tables(layout, S, 16, H, cuda_device)
    flat = [t.reshape(B * H, S, 64) for t in (q, k, v, do)]
    o_p, lse_p = bs.blocksparse_fwd_plain(*flat[:3], tables)
    delta = (do.float().reshape(B * H, S, 64) * o_p).sum(-1)
    dq_p = bs.blocksparse_bwd_dq_plain(*flat, lse_p, delta, tables)
    tolerance.check_kernel("blocksparse_bwd_dq", qg.grad.reshape(-1, S, 64),
                           dq_p)


@pytest.mark.gpu
def test_cuda_kernels_reject_what_they_do_not_take(cuda_device):
    layout = np.ones((1, 4, 4), np.int64)
    q32 = torch.zeros(2, 64, 64, device=cuda_device)
    t16 = bs.layout_tables(layout, 64, 16, 2, cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bs.blocksparse_fwd(q32, q32, q32, t16)                  # fp32
    qd = torch.zeros(2, 64, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bs.blocksparse_fwd(qd, qd, qd, t16)                     # head dim 32
    qb = torch.zeros(2, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    t8 = bs.layout_tables(np.ones((1, 8, 8), np.int64), 64, 8, 2,
                          cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bs.blocksparse_fwd(qb, qb, qb, t8)                      # block 8
