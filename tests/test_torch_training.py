"""deepspeed_tpu_torch training vs the JAX package, on the CPU.

The same weights (drawn by the JAX model's init, carried across by the
port's bridge) and the same seeded token batches go through both
packages: the GPT-2 training model's logits, losses and every gradient
leaf at fp32 2e-5 in both tree layouts; then ``initialize`` +
``train_batch`` trajectories against the JAX engine on a 1-device CPU
mesh (the tests/test_engine.py pattern), and checkpoints across the two.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from torch_port_common import assert_close

VOCAB, SEQ = 512, 16


def _np32(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _jax_model(scan_layers=True, dtype=jnp.float32, **kw):
    cfg = jgpt2.gpt2_tiny(dtype=dtype, scan_layers=scan_layers, **kw)
    model = jgpt2.GPT2LMHeadModel(cfg)
    ids = jnp.zeros((1, SEQ), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids)["params"]
    return model, params


def _port_model(params, scan_layers=True, dtype=torch.float32, **kw):
    cfg = tgpt2.gpt2_tiny(dtype=dtype, scan_layers=scan_layers, **kw)
    model = tgpt2.GPT2LMHeadModel(cfg, device="cpu")
    model.load_state_dict(model.from_jax_tree(_np32(params)))
    return model


def _ids(batch=4, seed=0):
    return np.random.RandomState(seed).randint(
        0, VOCAB, size=(batch, SEQ)).astype(np.int32)


def _grads_by_name(model, tree):
    return model.from_jax_tree(_np32(tree))


@pytest.mark.parametrize("scan_layers", [True, False])
def test_model_logits_losses_and_grads_match_jax(scan_layers):
    jmodel, params = _jax_model(scan_layers)
    ids = _ids()

    def jloss(p):
        return jgpt2.lm_loss(jmodel.apply({"params": p}, ids), ids)
    logits_j = jmodel.apply({"params": params}, ids)
    loss_j, grads_j = jax.value_and_grad(jloss)(params)
    jchunk = jgpt2.GPT2LMHeadModel(jgpt2.gpt2_tiny(
        dtype=jnp.float32, scan_layers=scan_layers, loss_chunk=24))
    chunk_j = jchunk.apply({"params": params}, ids, labels=ids)

    model = _port_model(params, scan_layers)
    tids = torch.from_numpy(ids)
    assert_close(model(tids), np.asarray(logits_j))
    loss = tgpt2.lm_loss(model(tids), tids)
    assert_close(loss, np.asarray(loss_j))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = _grads_by_name(model, grads_j)
    for name, g in zip(names, grads):
        assert_close(g, want[name])

    chunked = tgpt2.GPT2LMHeadModel(tgpt2.gpt2_tiny(
        dtype=torch.float32, scan_layers=scan_layers, loss_chunk=24),
        device="cpu")
    chunked.load_state_dict(model.state_dict())
    loss_c = chunked(tids, labels=tids)          # 60 tokens: a padded chunk
    assert_close(loss_c, np.asarray(chunk_j))
    grads_c = torch.autograd.grad(loss_c, list(chunked.parameters()))
    for name, g in zip(names, grads_c):
        assert_close(g, want[name])


def test_bridge_roundtrips_both_layouts_and_remat_keeps_grads():
    _, params = _jax_model(scan_layers=True)
    model = _port_model(params)
    named = dict(model.named_parameters())
    for scan in (True, False):
        tree = model.jax_tree({k: v.detach() for k, v in named.items()},
                              scan_layers=scan)
        assert ("h" in tree) == scan
        back = model.from_jax_tree(tree)
        for k, v in named.items():
            assert torch.equal(back[k], v.detach())
    j = _np32(params)
    tree = model.jax_tree({k: v.detach() for k, v in named.items()})
    for path, leaf in jax.tree_util.tree_leaves_with_path(j):
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)

    tids = torch.from_numpy(_ids())
    remat = _port_model(params, remat=True)
    g0 = torch.autograd.grad(tgpt2.lm_loss(model(tids), tids),
                             list(model.parameters()))
    g1 = torch.autograd.grad(tgpt2.lm_loss(remat(tids), tids),
                             list(remat.parameters()))
    for a, b in zip(g0, g1):
        assert_close(a, b)


def test_model_refuses_what_is_not_ported():
    for kw in ({"remat": True, "remat_policy": "dots"}, {"dropout": 0.1},
               {"tie_word_embeddings": False}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tgpt2.GPT2LMHeadModel(tgpt2.gpt2_tiny(**kw))


# -- the engine ---------------------------------------------------------------

def _config(**over):
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "steps_per_print": 100, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"total_num_steps": 8,
                                    "warmup_num_steps": 2,
                                    "warmup_max_lr": 3e-3,
                                    "warmup_type": "linear"}},
           "zero_optimization": {"stage": 3}}
    cfg.update(over)
    return cfg


def _one_device_mesh():
    from deepspeed_tpu.parallel.mesh import MeshConfig, make_mesh
    return make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])


def _jax_engine(cfg, params, dtype=jnp.float32, **model_kw):
    model = jgpt2.GPT2LMHeadModel(jgpt2.gpt2_tiny(dtype=dtype, **model_kw))
    engine, _, _, _ = dstpu.initialize(config=cfg, model=model,
                                       model_parameters=params,
                                       mesh=_one_device_mesh())
    return engine


def _port_engine(cfg, params, dtype=torch.float32, **model_kw):
    model = tgpt2.GPT2LMHeadModel(tgpt2.gpt2_tiny(dtype=dtype, **model_kw))
    sd = model.from_jax_tree(_np32(params))
    engine, opt, _, sched = dst.initialize(config=cfg, model=model,
                                           model_parameters=sd, device="cpu")
    assert opt is engine.optimizer and sched is engine.lr_scheduler
    return engine


def _batches(n, batch=4):
    return [{"input_ids": _ids(batch, seed=i)} for i in range(n)]


def test_train_batch_trajectory_matches_jax_engine_fp32():
    """5 steps of AdamW with gas 2, clipping and WarmupDecayLR: equal
    losses, lr and grad norms at rtol 2e-5, and equal weights after."""
    _, params = _jax_model()
    cfg = _config()
    je, te = _jax_engine(cfg, params), _port_engine(cfg, params)
    for batch in _batches(5):
        lj = float(je.train_batch(batch))
        lt = te.train_batch(batch)
        assert torch.is_tensor(lt)
        assert float(lt) == pytest.approx(lj, rel=2e-5)
        assert te.get_lr()[0] == pytest.approx(je.get_lr()[0], rel=2e-5)
        assert float(te.get_global_grad_norm()) == pytest.approx(
            float(je.get_global_grad_norm()), rel=2e-5)
    assert te.global_steps == je.global_steps == 5
    want = te.module.from_jax_tree(_np32(jax.device_get(je.state.params)))
    for name, m in zip(te.param_names, te.master):
        assert_close(m, want[name], atol=2e-5, rtol=2e-5)


def test_train_batch_trajectory_matches_jax_engine_bf16():
    """bf16 compute with grad_dtype and moment_dtype bf16 (the GPT-2
    large training config): losses within 5e-2, gradients come out bf16
    and exp_avg is stored bf16."""
    _, params = _jax_model()
    cfg = _config(bf16={"enabled": True},
                  data_types={"grad_dtype": "bf16"},
                  optimizer={"type": "AdamW",
                             "params": {"lr": 3e-3, "weight_decay": 0.01,
                                        "moment_dtype": "bf16"}},
                  gradient_accumulation_steps=1)
    je = _jax_engine(cfg, params, dtype=jnp.bfloat16, loss_chunk=32)
    te = _port_engine(cfg, params, dtype=torch.bfloat16, loss_chunk=32)
    for batch in _batches(5):
        assert float(te.train_batch(batch)) == pytest.approx(
            float(je.train_batch(batch)), abs=5e-2)
    assert all(p.dtype == torch.bfloat16 for p in te.compute_params)
    assert all(m.dtype == torch.float32 for m in te.master)
    assert all(m.dtype == torch.bfloat16 for m in te.opt_state["exp_avg"])
    _, grads = te._micro_loss_and_grads(te._to_device(_batches(1)[0]))
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_forward_backward_step_equals_train_batch():
    _, params = _jax_model()
    cfg = _config()
    e1, e2 = _port_engine(cfg, params), _port_engine(cfg, params)
    batch = _batches(1)[0]
    ids = batch["input_ids"]
    for _ in range(2):
        la = e1.train_batch(batch)
        assert e2.is_gradient_accumulation_boundary() is False
        for i in range(2):
            loss = e2.forward({"input_ids": ids[i * 2:(i + 1) * 2]})
            e2.backward(loss)
            e2.step()
            assert e2.global_steps == e1.global_steps - (1 - i)
    assert float(e2.get_global_grad_norm()) == pytest.approx(
        float(e1.get_global_grad_norm()), rel=2e-5)
    for a, b in zip(e1.master, e2.master):
        assert_close(a, b)
    assert float(la) > 0


def test_fp16_overflow_step_is_skipped_and_the_scale_halves():
    """A (x, y) float batch with an inf: the step is skipped (masters,
    moments and the Adam step count keep their values), the scale halves,
    and the device step counter the LR schedule reads does not move."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4))
    cfg = {"train_batch_size": 8, "steps_per_print": 100,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "fp16": {"enabled": True, "initial_scale_power": 4,
                    "hysteresis": 1}}
    engine, _, _, _ = dst.initialize(config=cfg, model=model, device="cpu")
    rs = np.random.RandomState(0)
    x = rs.randn(8, 8).astype(np.float32)
    y = rs.randint(0, 4, 8).astype(np.int64)
    engine.train_batch((x, y))
    assert engine.loss_scale == 16.0
    state = engine.opt_state
    before = [t.clone() for t in engine.master + state["exp_avg"]
              + state["exp_avg_sq"]]
    step_before = int(engine.opt_state["step"])
    x_bad = x.copy()
    x_bad[0, 0] = np.inf
    engine.train_batch((x_bad, y))
    after = engine.master + state["exp_avg"] + state["exp_avg_sq"]
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert int(engine.opt_state["step"]) == step_before
    assert engine.loss_scale == 8.0
    assert int(engine.global_step_t) == 1 and engine.global_steps == 2
    assert int(engine.skipped_steps_t) == 1


@pytest.mark.parametrize("moment_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_finite_flag_keeps_or_skips_the_step(moment_dtype, adam_w_mode):
    """FusedAdam's ``finite`` flag: True gives the step that no flag
    gives, bit for bit; False leaves params, moments and the step count
    as they were, bit for bit, whatever inf or nan the grads hold."""
    from deepspeed_tpu_torch.ops.adam import FusedAdam
    opt = FusedAdam(lr=1e-2, weight_decay=0.1, adam_w_mode=adam_w_mode,
                    moment_dtype=moment_dtype)
    rs = np.random.RandomState(0)
    shapes = [(8, 16), (16,), (4,)]

    def fresh():
        params = [torch.from_numpy(rs.randn(*s).astype(np.float32))
                  for s in shapes]
        state = opt.init(params)
        opt.step(params, [torch.ones_like(p) for p in params], state,
                 torch.tensor(1e-2), grad_scale=torch.tensor(0.5))
        return params, state

    def flat(params, state):
        return params + state["exp_avg"] + state["exp_avg_sq"] \
            + [state["step"]]

    grads = [torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in shapes]
    p1, s1 = fresh()
    p2, s2 = [p.clone() for p in p1], {
        k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
        for k, v in s1.items()}
    lr, scale = torch.tensor(3e-3), torch.tensor(0.25)
    opt.step(p1, [g.clone() for g in grads], s1, lr, grad_scale=scale)
    opt.step(p2, [g.clone() for g in grads], s2, lr, grad_scale=scale,
             finite=torch.tensor(True))
    for a, b in zip(flat(p1, s1), flat(p2, s2)):
        assert torch.equal(a, b)

    params, state = fresh()
    before = [t.clone() for t in flat(params, state)]
    bad = [g.clone() for g in grads]
    bad[0][0, 0], bad[1][3] = np.inf, np.nan
    opt.step(params, bad, state, lr, grad_scale=scale,
             finite=torch.tensor(False))
    for a, b in zip(before, flat(params, state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("moment_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("finite", [None, True, False])
def test_adam_leaf_groups_change_no_bit(monkeypatch, moment_dtype, finite):
    """FusedAdam updates its leaves in groups of at most GROUP_ELEMENTS
    elements (its fp32 scratch a group's size): a group a leaf, or two
    leaves a group, gives the one-group step bit for bit, the step count
    included."""
    from deepspeed_tpu_torch.ops import adam
    opt = adam.FusedAdam(lr=1e-2, weight_decay=0.1, moment_dtype=moment_dtype)
    rs = np.random.RandomState(1)
    shapes = [(8, 16), (16,), (4, 4), (3,)]
    grads = [torch.from_numpy(rs.randn(*s).astype(np.float32))
             .to(torch.bfloat16) for s in shapes]
    flag = None if finite is None else torch.tensor(finite)

    def run(group):
        monkeypatch.setattr(adam, "GROUP_ELEMENTS", group)
        params = [torch.from_numpy(np.random.RandomState(2).randn(*s)
                                   .astype(np.float32)) for s in shapes]
        state = opt.init(params)
        for _ in range(2):
            opt.step(params, grads, state, torch.tensor(3e-3),
                     grad_scale=torch.tensor(0.5), finite=flag)
        return params + state["exp_avg"] + state["exp_avg_sq"] \
            + [state["step"]]
    assert adam._groups([torch.empty(s) for s in shapes]) == [[0, 1, 2, 3]]
    one = run(1 << 27)
    monkeypatch.setattr(adam, "GROUP_ELEMENTS", 144)
    assert adam._groups([torch.empty(s) for s in shapes]) == [[0, 1],
                                                             [2, 3]]
    for group in (1, 144):
        for a, b in zip(one, run(group)):
            assert torch.equal(a, b)


def test_checkpoint_needs_the_weight_bridge(tmp_path):
    """A model without ``jax_tree``/``from_jax_tree`` cannot be written
    in the JAX checkpoint format: save and load raise, and nothing is
    written."""
    model = torch.nn.Linear(4, 2)
    cfg = {"train_batch_size": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    engine, _, _, _ = dst.initialize(config=cfg, model=model, device="cpu")
    with pytest.raises(NotImplementedError, match="weight bridge"):
        engine.save_checkpoint(str(tmp_path))
    assert list(tmp_path.iterdir()) == []


def test_self_attention_takes_another_attention_function():
    """``SelfAttention.attention`` set on an instance replaces the
    attention function (chip_smoke's grad check swaps in the plain
    flash versions so); the flash Function on CPU gives the reference
    loss and gradients at fp32 2e-5."""
    from deepspeed_tpu_torch.ops.attention import FlashAttentionFunction
    _, params = _jax_model()
    model = _port_model(params)
    tids = torch.from_numpy(_ids())
    params_ = list(model.parameters())
    want_loss = tgpt2.lm_loss(model(tids), tids)
    want = torch.autograd.grad(want_loss, params_)
    calls = []

    def flash(q, k, v, causal=False):
        calls.append(q.shape)
        return FlashAttentionFunction.apply(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal)
    for block in model.h:
        block.attn.attention = flash
    got_loss = tgpt2.lm_loss(model(tids), tids)
    got = torch.autograd.grad(got_loss, params_)
    assert len(calls) == len(model.h)
    assert_close(got_loss, want_loss)
    for a, b in zip(got, want):
        assert_close(a, b)
    for block in model.h:
        del block.attn.attention
    model(tids)
    assert len(calls) == len(model.h)


def test_data_iter_and_loader_batches():
    """train_batch(data_iter=...) over the port's loader draws the JAX
    loader's order."""
    from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JL
    from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                        RepeatingLoader)
    data = [{"input_ids": _ids(1, seed=i)[0]} for i in range(12)]
    for a, b in zip(JL(data, 2, seed=7), DeepSpeedDataLoader(data, 2, seed=7)):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    _, params = _jax_model()
    engine = _port_engine(_config(), params)
    it = iter(RepeatingLoader(engine.deepspeed_io(data)))
    assert math.isfinite(float(engine.train_batch(data_iter=it)))
    assert engine.global_steps == 1 and engine.micro_steps == 2


# -- checkpoints --------------------------------------------------------------

def test_checkpoint_roundtrip_continues_the_trajectory(tmp_path):
    _, params = _jax_model()
    cfg = _config()
    batches = _batches(6)
    e1 = _port_engine(cfg, params)
    for b in batches[:3]:
        e1.train_batch(b)
    e1.save_checkpoint(str(tmp_path), client_state={"note": "hi"})
    assert (tmp_path / "latest").read_text() == "global_step3"
    e2 = _port_engine(cfg, params)
    e2.train_batch(batches[5])              # move it off the trajectory
    tag, client = e2.load_checkpoint(str(tmp_path))
    assert tag == "global_step3" and client == {"note": "hi"}
    assert e2.global_steps == 3
    for b in batches[3:]:
        assert float(e2.train_batch(b)) == float(e1.train_batch(b))
    for a, b in zip(e1.master, e2.master):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bf16", [False, True])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, bf16):
    """The JAX engine saves at step 3; the port loads it and its steps 4-6
    match JAX's own continuation. The port's save of the same state reads
    back in the JAX package leaf for leaf (bf16 moments included)."""
    _, params = _jax_model()
    cfg = _config()
    jdt, tdt = jnp.float32, torch.float32
    if bf16:
        cfg = _config(optimizer={"type": "AdamW", "params": {
            "lr": 3e-3, "weight_decay": 0.01, "moment_dtype": "bf16"}})
    batches = _batches(6)
    te = _port_engine(cfg, params, dtype=tdt)
    je = _jax_engine(cfg, params, dtype=jdt)
    for b in batches[:3]:
        je.train_batch(b)
    je.save_checkpoint(str(tmp_path / "jax"))
    tag, _ = te.load_checkpoint(str(tmp_path / "jax"))
    assert tag == "global_step3" and te.global_steps == 3
    te.save_checkpoint(str(tmp_path / "port"))
    from deepspeed_tpu.runtime import checkpointing as jckpt
    jstate, jmeta = jckpt.load_checkpoint(str(tmp_path / "jax"))
    pstate, pmeta = jckpt.load_checkpoint(str(tmp_path / "port"))
    jl = jax.tree_util.tree_leaves_with_path(jstate)
    pl = dict(jax.tree_util.tree_leaves_with_path(pstate))
    assert len(jl) == len(pl)
    for path, leaf in jl:
        got = pl[path]
        assert np.asarray(got).dtype == np.asarray(leaf).dtype, path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf))
    assert pmeta["global_steps"] == jmeta["global_steps"] == 3
    for b in batches[3:]:
        assert float(te.train_batch(b)) == pytest.approx(
            float(je.train_batch(b)), rel=2e-5)


# -- config and device --------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3,
     "gradient_accumulation_steps": 2},
    {"steps_per_print": 1},
    {"train_batch_size": 8, "data_types": {"grad_dtype": "fp16"}},
    {"train_batch_size": 8, "data_types": {"grad_accum_dtype": "int8"}},
    {"train_batch_size": 8, "fp16": {"enabled": True},
     "bf16": {"enabled": True}},
    {"train_batch_size": 8, "zero_optimization": {"stage": 4}},
])
def test_config_errors_carry_the_jax_messages(cfg):
    from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig
    with pytest.raises((ValueError, AssertionError)) as want:
        JConfig(cfg)
    with pytest.raises((ValueError, AssertionError)) as got:
        DeepSpeedConfig(cfg)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("block", [
    # the offload tiers with stage3_prefetch build (the engine falls back,
    # as JAX's does); partitioned activations beside it do not
    {"zero_optimization": {"stage": 3, "stage3_prefetch": True,
                           "offload_param": {"device": "cpu"}},
     "activation_checkpointing": {"partition_activations": True}},
    {"zero_optimization": {"stage": 3, "stage3_prefetch": True,
                           "stage3_prefetch_gather": "fused"}},
    {"comm": {"hierarchy": {"slow_axis": 2}}},
    {"optimizer": {"type": "Lamb", "params": {}}},
    {"optimizer": {"type": "SGD", "params": {}}},
    {"optimizer": {"type": "OneBitAdam", "params": {}}},
    {"sparse_gradients": True},
    {"snapshot": {"path": "/nonexistent"}},
    {"monitor": {}},
    {"monitor": {"watchdog": {"dump_dir": "/nonexistent"}}},
    {"profiling": {"trace_dir": "/nonexistent", "trace_steps": [1, 2]}},
    {"elasticity": {"enabled": True}},
])
def test_config_blocks_not_ported_raise_naming_roadmap(block):
    cfg = dict({"train_batch_size": 8}, **block)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        DeepSpeedConfig(cfg)


def test_config_batch_triangle_and_fields_match_jax():
    from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig
    for cfg in ({"train_batch_size": 8, "gradient_accumulation_steps": 2},
                {"train_micro_batch_size_per_gpu": 2,
                 "gradient_accumulation_steps": 3},
                {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4},
                _config(bf16={"enabled": True},
                        data_types={"grad_dtype": "bf16",
                                    "grad_accum_dtype": "bf16"})):
        j, t = JConfig(cfg), DeepSpeedConfig(cfg)
        for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                    "gradient_accumulation_steps", "grad_dtype",
                    "grad_accum_dtype", "bf16_enabled", "fp16_enabled",
                    "gradient_clipping", "optimizer_name", "scheduler_name",
                    "zero_optimization_stage", "steps_per_print", "seed"):
            assert getattr(t, key) == getattr(j, key), key


def test_initialize_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = tgpt2.GPT2LMHeadModel(tgpt2.gpt2_tiny(dtype=torch.float32))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        dst.initialize(config=_config(), model=model)
    engine, _, _, _ = dst.initialize(config=_config(), model=model,
                                     device="cpu")
    assert engine.master[0].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="one rank"):
        dst.initialize(config=_config(), model=model, device="cpu",
                       mesh=object())
