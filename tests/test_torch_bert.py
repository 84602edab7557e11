"""deepspeed_tpu_torch BERT and its training layer vs the JAX package.

The same weights (drawn by the JAX model's init, carried across by the
port's bridge) and the same seeded batches go through both packages at
fp32: the fused training layer (pre-LN and post-LN, dense and sparse,
with no mask, a 2-D mask and a 4-D bias), the BERT models' outputs, the
pretraining loss and every gradient leaf; 5-step ``initialize`` +
``train_batch`` trajectories against the JAX engine, with and without
the block-sparse layout; and checkpoints across the two packages. On
the card, a sparse BERT step launches each block-sparse kernel once a
layer.
"""

import importlib

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.ops.cuda import builder
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import (
    BertSparseSelfAttention, SparseAttentionUtils)
from deepspeed_tpu_torch.ops.transformer import transformer as ttr
from torch_port_common import assert_close, cuda_device  # noqa: F401

B, S = 2, 64


def _jax(name):
    """A module of jax or of the JAX package, imported here and not at the
    top so the gpu tests also run where JAX is not installed."""
    return importlib.import_module(name)


def _np32(tree):
    jax = _jax("jax")
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v, np.float32))
    return out


def _sparsity(module):
    """The per-head Fixed layout (2 global patterns) both packages take."""
    return module.FixedSparsityConfig(
        num_heads=2, block=16, different_layout_per_head=True,
        num_local_blocks=2, num_global_blocks=1,
        num_different_global_patterns=2)


def _batch(cfg, seed=0, mask=True):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.where(rs.rand(B, S) < 0.15, ids, -100).astype(np.int32)
    batch = {"input_ids": ids,
             "token_type_ids": (rs.rand(B, S) < 0.5).astype(np.int32),
             "mlm_labels": labels,
             "nsp_labels": rs.randint(0, 2, (B,)).astype(np.int32)}
    if mask:
        m = np.ones((B, S), np.int32)
        m[1, S - 8:] = 0
        batch["attention_mask"] = m
    return batch


# -- the training layer -------------------------------------------------------

def _mask(kind):
    rs = np.random.RandomState(4)
    if kind == "2d":
        m = np.ones((B, S), np.int32)
        m[0, S - 12:] = 0
        return m
    if kind == "4d":
        return np.where(rs.rand(B, 1, S, S) < 0.2, -1e4, 0.0) \
            .astype(np.float32)
    return None


@pytest.mark.parametrize("mask", [None, "2d", "4d"])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_transformer_layer_matches_jax(pre_ln, sparse, mask):
    jax = _jax("jax")
    jnp = _jax("jax.numpy")
    jtr = _jax("deepspeed_tpu.ops.transformer.transformer")
    kw = dict(hidden_size=64, intermediate_size=96, heads=2,
              num_hidden_layers=2, pre_layer_norm=pre_ln)
    jcfg = jtr.DeepSpeedTransformerConfig(
        dtype=jnp.float32, **kw,
        sparsity_config=_sparsity(_jax(
            "deepspeed_tpu.ops.sparse_attention")) if sparse else None)
    x = np.random.RandomState(0).randn(B, S, 64).astype(np.float32)
    layer = jtr.DeepSpeedTransformerLayer(jcfg)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    m = _mask(mask)
    want = layer.apply({"params": params}, jnp.asarray(x),
                       None if m is None else jnp.asarray(m))
    tcfg = ttr.DeepSpeedTransformerConfig(
        dtype=torch.float32, **kw,
        sparsity_config=_sparsity(tsc) if sparse else None)
    tl = ttr.transformer_layer(tcfg, device="cpu")
    tl.load_state_dict(_flat(params))
    got = tl(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    assert_close(got, np.asarray(want))


def test_layer_refuses_remat_knobs_and_dropout_in_training():
    for knob in ("normalize_invertible", "gelu_checkpoint",
                 "attn_dropout_checkpoint"):
        cfg = ttr.DeepSpeedTransformerConfig(hidden_size=64, heads=2,
                                             **{knob: True})
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            ttr.transformer_layer(cfg)
    x = torch.zeros(1, 16, 64)
    for kw in ({"attn_dropout_ratio": 0.1}, {"hidden_dropout_ratio": 0.1}):
        layer = ttr.DeepSpeedTransformerLayer(ttr.DeepSpeedTransformerConfig(
            hidden_size=64, heads=2, dtype=torch.float32, **kw), "cpu")
        layer.reset_parameters(torch.Generator().manual_seed(0))
        layer(x)                                   # deterministic: no-op
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            layer(x, deterministic=False)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        tbert.BertModel(tbert.bert_tiny(gelu_checkpoint=True))


def test_canonical_mask_matches_jax():
    jtr = _jax("deepspeed_tpu.ops.transformer.transformer")
    for m in (_mask("2d"), _mask("2d").astype(bool),
              _mask("2d").astype(np.float32), _mask("4d"),
              _mask("4d")[:, 0]):
        jb, js = jtr._canonical_mask(m)
        tb, ts = ttr._canonical_mask(torch.from_numpy(m))
        for got, want in ((tb, jb), (ts, js)):
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the models ---------------------------------------------------------------

def _models(kind="pretraining", sparse=False, scan=False, pre_ln=False,
            **kw):
    """(JAX model, its params, the port model with those weights)."""
    jax = _jax("jax")
    jnp = _jax("jax.numpy")
    jbert = _jax("deepspeed_tpu.models.bert")
    sp = _sparsity(_jax("deepspeed_tpu.ops.sparse_attention")) \
        if sparse else None
    jcfg = jbert.bert_tiny(dtype=jnp.float32, scan_layers=scan,
                           pre_layer_norm=pre_ln, sparsity_config=sp, **kw)
    tcfg = tbert.bert_tiny(dtype=torch.float32, scan_layers=scan,
                           pre_layer_norm=pre_ln,
                           sparsity_config=_sparsity(tsc) if sparse else None,
                           **kw)
    jcls, tcls = {"pretraining": (jbert.BertForPreTraining,
                                  tbert.BertForPreTraining),
                  "qa": (jbert.BertForQuestionAnswering,
                         tbert.BertForQuestionAnswering),
                  "cls": (jbert.BertForSequenceClassification,
                          tbert.BertForSequenceClassification)}[kind]
    jmodel = jcls(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, S), jnp.int32))["params"]
    tmodel = tcls(tcfg, device="cpu")
    tmodel.load_state_dict(tmodel.from_jax_tree(_np32(params)))
    return jmodel, params, tmodel


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _apply(model, batch):
    return model(batch["input_ids"], batch.get("attention_mask"),
                 batch.get("token_type_ids"))


@pytest.mark.parametrize("sparse,mask,pre_ln", [(False, True, False),
                                                (True, False, False),
                                                (True, True, True)])
def test_pretraining_outputs_loss_and_grads_match_jax(sparse, mask, pre_ln):
    """Outputs, ``pretraining_loss`` and every gradient leaf at fp32 2e-5;
    the sparse model without a mask runs the block-sparse kernels' plain
    versions on the port's side."""
    jax = _jax("jax")
    jbert = _jax("deepspeed_tpu.models.bert")
    jmodel, params, tmodel = _models(sparse=sparse, pre_ln=pre_ln)
    batch = _batch(tmodel.config, mask=mask)

    def jloss(p):
        out = jmodel.apply({"params": p}, batch["input_ids"],
                           batch.get("attention_mask"),
                           batch["token_type_ids"])
        return jbert.pretraining_loss(out, batch), out
    (loss_j, (mlm_j, nsp_j)), grads_j = jax.value_and_grad(
        jloss, has_aux=True)(params)
    tb = _t(batch)
    n0 = builder.launches["sparse_attention_dense"]
    mlm, nsp = _apply(tmodel, tb)
    dense_calls = builder.launches["sparse_attention_dense"] - n0
    assert dense_calls == (2 if sparse and mask else 0)
    assert_close(mlm, np.asarray(mlm_j))
    assert_close(nsp, np.asarray(nsp_j))
    loss = tbert.pretraining_loss((mlm, nsp), tb)
    assert_close(loss, np.asarray(loss_j))
    names = [n for n, _ in tmodel.named_parameters()]
    grads = torch.autograd.grad(loss, list(tmodel.parameters()))
    want = tmodel.from_jax_tree(_np32(grads_j))
    assert len(want) == len(names) == len(jax.tree_util.tree_leaves(params))
    for name, g in zip(names, grads):
        assert_close(g, want[name])


@pytest.mark.parametrize("kind", ["qa", "cls"])
def test_qa_and_classification_heads_match_jax(kind):
    jmodel, params, tmodel = _models(kind, sparse=True)
    batch = _batch(tmodel.config)
    want = jmodel.apply({"params": params}, batch["input_ids"],
                        batch["attention_mask"], batch["token_type_ids"])
    got = _apply(tmodel, _t(batch))
    for g, w in zip(got if kind == "qa" else (got,),
                    want if kind == "qa" else (want,)):
        assert g.dtype == torch.float32
        assert_close(g, np.asarray(w))


@pytest.mark.parametrize("scan", [False, True])
def test_bridge_roundtrips_both_layouts(scan):
    """JAX tree → port → JAX tree is equal leaf for leaf (both layouts),
    the port's names cover the tree, and ``num_params`` counts it."""
    jax = _jax("jax")
    _, params, tmodel = _models(scan=scan, pre_ln=True)
    named = {k: v.detach() for k, v in tmodel.named_parameters()}
    tree = tmodel.jax_tree(named)
    leaves = jax.tree_util.tree_leaves_with_path(_np32(params))
    assert len(leaves) == len(jax.tree_util.tree_leaves(tree))
    for path, leaf in leaves:
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    other = tmodel.jax_tree(named, scan_layers=not scan)
    back = tmodel.from_jax_tree(other)
    for k, v in named.items():
        assert torch.equal(back[k], v)
    assert sum(p.numel() for p in tmodel.bert.parameters()) == \
        tmodel.config.num_params()


def test_seeded_init_is_reproducible_and_on_scale():
    cfg = tbert.bert_tiny(dtype=torch.float32)
    a, b = (tbert.BertForPreTraining(cfg, device="cpu") for _ in range(2))
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), name
    assert not a.mlm_bias.any()
    w = a.bert.embeddings.word_embeddings.detach()
    assert abs(float(w.std()) - 0.02) < 2e-3
    out_w = a.bert.encoder.layer[0].attn_ow.kernel.detach()
    assert abs(float(out_w.std()) - 0.01) < 2e-3      # 0.02 / sqrt(2 L)


# -- the sparse utils ---------------------------------------------------------

def test_extend_position_embedding_named_and_jax_tree():
    jutils = _jax("deepspeed_tpu.ops.sparse_attention.sparse_attention_utils")
    _, params, tmodel = _models()
    jext = jutils.SparseAttentionUtils.extend_position_embedding(params, 300)
    tree_ext = SparseAttentionUtils.extend_position_embedding(
        _np32(params), 300)
    named_ext = SparseAttentionUtils.extend_position_embedding(
        tmodel.state_dict(), 300)
    want = np.asarray(jext["bert"]["embeddings"]["position_embeddings"])
    assert want.shape == (300, 64)
    np.testing.assert_array_equal(
        tree_ext["bert"]["embeddings"]["position_embeddings"], want)
    np.testing.assert_array_equal(
        named_ext["bert.embeddings.position_embeddings"].numpy(), want)
    assert torch.equal(named_ext["bert.embeddings.word_embeddings"],
                       tmodel.state_dict()["bert.embeddings.word_embeddings"])
    big = tbert.BertForPreTraining(tbert.bert_tiny(
        dtype=torch.float32, max_position_embeddings=300), device="cpu")
    big.load_state_dict(named_ext)


@pytest.mark.parametrize("S_in,mask", [(50, True), (64, False)])
def test_pad_to_block_size_matches_jax(S_in, mask):
    jnp = _jax("jax.numpy")
    jutils = _jax("deepspeed_tpu.ops.sparse_attention.sparse_attention_utils")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 9, (2, S_in)).astype(np.int32)
    m = np.ones((2, S_in), np.int32) if mask else None
    emb = rs.randn(2, S_in, 8).astype(np.float32)
    want = jutils.SparseAttentionUtils.pad_to_block_size(
        16, input_ids=jnp.asarray(ids),
        attention_mask=None if m is None else jnp.asarray(m),
        inputs_embeds=jnp.asarray(emb), pad_token_id=7)
    got = SparseAttentionUtils.pad_to_block_size(
        16, input_ids=torch.from_numpy(ids),
        attention_mask=None if m is None else torch.from_numpy(m),
        inputs_embeds=torch.from_numpy(emb), pad_token_id=7)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out = torch.zeros(2, S_in + got[0], 8)
    assert SparseAttentionUtils.unpad_sequence_output(got[0], out).shape \
        == (2, S_in, 8)


def test_sparse_config_for_and_bert_sparse_self_attention_match_jax():
    jax = _jax("jax")
    jnp = _jax("jax.numpy")
    jutils = _jax("deepspeed_tpu.ops.sparse_attention.sparse_attention_utils")
    cfg = SparseAttentionUtils.sparse_config_for(tbert.bert_tiny())
    assert isinstance(cfg.sparsity_config, tsc.FixedSparsityConfig)
    assert cfg.sparsity_config.num_heads == 2
    x = np.random.RandomState(0).randn(B, S, 64).astype(np.float32)
    jmod = jutils.BertSparseSelfAttention(
        hidden_size=64, num_attention_heads=2,
        sparsity_config=_sparsity(_jax("deepspeed_tpu.ops.sparse_attention")),
        dtype=jnp.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tmod = BertSparseSelfAttention(64, 2, _sparsity(tsc),
                                   dtype=torch.float32, device="cpu")
    tmod.load_state_dict(_flat(params))
    m = _mask("2d")
    for mask in (None, m):
        want = jmod.apply({"params": params}, jnp.asarray(x),
                          None if mask is None else jnp.asarray(mask))
        got = tmod(torch.from_numpy(x),
                   None if mask is None else torch.from_numpy(mask))
        assert_close(got, np.asarray(want))


# -- the engine ---------------------------------------------------------------

def _ds_config(sparse):
    cfg = {"train_batch_size": B, "steps_per_print": 100,
           "gradient_clipping": 1.0,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    if sparse:
        cfg["sparse_attention"] = {
            "mode": "fixed", "block": 16, "different_layout_per_head": True,
            "num_local_blocks": 2, "num_global_blocks": 1,
            "num_different_global_patterns": 2}
    return cfg


def _engines(sparse, mask):
    """The JAX engine on a 1-device CPU mesh and the port's, from the
    same weights; the sparse layout comes from the config's block through
    config_to_sparsity + sparse_config_for on both sides."""
    jax = _jax("jax")
    jnp = _jax("jax.numpy")
    dstpu = _jax("deepspeed_tpu")
    jbert = _jax("deepspeed_tpu.models.bert")
    jsc = _jax("deepspeed_tpu.ops.sparse_attention.sparsity_config")
    jcc = _jax("deepspeed_tpu.config.config")
    jutils = _jax("deepspeed_tpu.ops.sparse_attention.sparse_attention_utils")
    from deepspeed_tpu.parallel.mesh import MeshConfig, make_mesh
    from deepspeed_tpu_torch.config.config import SparseAttentionConfig
    ds = _ds_config(sparse)
    jcfg = jbert.bert_tiny(dtype=jnp.float32)
    tcfg = tbert.bert_tiny(dtype=torch.float32)
    if sparse:
        jcfg = jutils.SparseAttentionUtils.sparse_config_for(
            jcfg, jsc.config_to_sparsity(jcc.SparseAttentionConfig(ds), 2))
        tcfg = SparseAttentionUtils.sparse_config_for(
            tcfg, tsc.config_to_sparsity(SparseAttentionConfig(ds), 2))
    jmodel = jbert.BertForPreTraining(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, S), jnp.int32))["params"]

    def jloss(p, batch):
        out = jmodel.apply({"params": p}, batch["input_ids"],
                           batch.get("attention_mask"),
                           batch["token_type_ids"])
        return jbert.pretraining_loss(out, batch)

    def tloss(model, batch):
        return tbert.pretraining_loss(_apply(model, batch), batch)

    je, _, _, _ = dstpu.initialize(
        config=ds, model=jmodel, model_parameters=params, loss_fn=jloss,
        mesh=make_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    tmodel = tbert.BertForPreTraining(tcfg)
    te, _, _, _ = dst.initialize(
        config=ds, model=tmodel,
        model_parameters=tmodel.from_jax_tree(_np32(params)), loss_fn=tloss,
        device="cpu")
    batches = [_batch(tcfg, seed=i, mask=mask) for i in range(6)]
    return je, te, batches


@pytest.mark.parametrize("sparse,mask", [(False, True), (True, False)])
def test_train_batch_trajectory_matches_jax_engine(sparse, mask):
    """5 Adam steps with clipping: losses and grad norms at rtol 2e-5
    and the weights after them at fp32 2e-5."""
    jax = _jax("jax")
    je, te, batches = _engines(sparse, mask)
    assert te._config.sparse_attention_config.enabled == sparse
    for batch in batches[:5]:
        lj = float(je.train_batch(batch))
        assert float(te.train_batch(batch)) == pytest.approx(lj, rel=2e-5)
        assert float(te.get_global_grad_norm()) == pytest.approx(
            float(je.get_global_grad_norm()), rel=2e-5)
    want = te.module.from_jax_tree(_np32(jax.device_get(je.state.params)))
    for name, m in zip(te.param_names, te.master):
        assert_close(m, want[name])


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX engine saves at step 3; the port loads it and its steps
    4-5 match JAX's continuation; the port's save of that state reads
    back in the JAX package leaf for leaf."""
    jax = _jax("jax")
    from deepspeed_tpu.runtime import checkpointing as jckpt
    je, te, batches = _engines(True, False)
    for b in batches[:3]:
        je.train_batch(b)
    je.save_checkpoint(str(tmp_path / "jax"))
    tag, _ = te.load_checkpoint(str(tmp_path / "jax"))
    assert tag == "global_step3" and te.global_steps == 3
    te.save_checkpoint(str(tmp_path / "port"))
    jstate, _ = jckpt.load_checkpoint(str(tmp_path / "jax"))
    pstate, _ = jckpt.load_checkpoint(str(tmp_path / "port"))
    jl = jax.tree_util.tree_leaves_with_path(jstate)
    pl = dict(jax.tree_util.tree_leaves_with_path(pstate))
    assert len(jl) == len(pl)
    for path, leaf in jl:
        np.testing.assert_array_equal(np.asarray(pl[path]), np.asarray(leaf))
    for b in batches[3:5]:
        assert float(te.train_batch(b)) == pytest.approx(
            float(je.train_batch(b)), rel=2e-5)


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_sparse_bert_step_launches_each_kernel_once_a_layer(
        cuda_device):
    """A bf16 train_batch of a 2-layer sparse BERT (head dim 64, no
    mask) on the card: each block-sparse kernel launches once a layer,
    flash and the masked-dense path never; the loss is finite."""
    sp = tsc.FixedSparsityConfig(num_heads=2, block=16,
                                 different_layout_per_head=True,
                                 num_local_blocks=4,
                                 num_different_global_patterns=2)
    cfg = tbert.bert_tiny(hidden_size=128, intermediate_size=256,
                          max_position_embeddings=256, sparsity_config=sp)
    engine, _, _, _ = dst.initialize(
        config={"train_batch_size": 2, "bf16": {"enabled": True},
                "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}},
        model=tbert.BertForPreTraining(cfg),
        loss_fn=lambda m, b: tbert.pretraining_loss(
            m(b["input_ids"], None, b["token_type_ids"]), b))
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    batch = {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
             "mlm_labels": np.where(rs.rand(2, 256) < 0.15, ids, -100)
             .astype(np.int32),
             "nsp_labels": np.array([0, 1], np.int32)}
    builder.launches.clear()
    loss = float(engine.train_batch(batch))
    torch.cuda.synchronize()
    assert np.isfinite(loss)
    launches = dict(builder.launches)
    assert launches == {"blocksparse_fwd": 2, "blocksparse_bwd_dq": 2,
                        "blocksparse_bwd_dkv": 2}, launches
