"""deepspeed_tpu_torch MoQ, eigenvalues and progressive layer drop vs the
JAX package, on the CPU.

The ``Quantizer`` schedule state for state; ``quantize_tree`` leaf for
leaf, bit for bit, on a tiny GPT-2 in both tree layouts (the same leaves
skipped: under the scan layout the layer kernels are 3-D stacked leaves);
``initialize`` + ``train_batch`` with ``quantize_training`` and with
``progressive_layer_drop`` against the JAX engine on a 1-device mesh; the
Hessian-vector product and per-layer eigenvalues; and the attention
Functions refusing a second derivative. The power iteration's own cases
and the engine's eigenvalue-scaled periods are in
tests/test_torch_moq_eigenvalues.py, which shares this file's helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.eigenvalue import Eigenvalue as JEigenvalue
from deepspeed_tpu.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as JPLD
from deepspeed_tpu.runtime.quantize import Quantizer as JQuantizer
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop
from deepspeed_tpu_torch.runtime.quantize import Quantizer
from torch_port_common import assert_close

VOCAB, SEQ = 128, 16


def _np32(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _jax_params(scan_layers):
    cfg = jgpt2.gpt2_tiny(dtype=jnp.float32, scan_layers=scan_layers,
                          vocab_size=VOCAB)
    model = jgpt2.GPT2LMHeadModel(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, SEQ), jnp.int32))["params"]
    return model, params


def _port_model(scan_layers):
    return tgpt2.GPT2LMHeadModel(tgpt2.gpt2_tiny(
        dtype=torch.float32, scan_layers=scan_layers, vocab_size=VOCAB),
        device="cpu")


def _ids(batch=4, seed=0):
    return np.random.RandomState(seed).randint(
        0, VOCAB, size=(batch, SEQ)).astype(np.int32)


def _bits_equal(a, b, what=""):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                  err_msg=what)


# -- the schedule -------------------------------------------------------------

def _state(q):
    return (list(q.q_start_bits), list(q.q_period), q.qsteps,
            q.quantize_real_ratio)


@pytest.mark.parametrize("kw,overflow_every,eig_every", [
    (dict(q_start_bits=16, q_target_bits=8, q_period=6), 0, 0),
    (dict(q_start_bits=12, q_target_bits=4, q_period=3, layer_num=3,
          q_eigenvalue=True), 0, 4),
    (dict(q_start_bits=10, q_target_bits=6, q_period=2), 3, 0),
    (dict(q_start_bits=10, q_target_bits=6, q_period=2, q_mixed_fp16=True,
          q_change_ratio=0.05), 3, 0),
    (dict(q_start_bits=16, q_target_bits=8, q_period=40, layer_num=2,
          q_eigenvalue=True, q_mixed_fp16=True, q_change_ratio=0.125), 5, 2),
])
def test_schedule_matches_jax_over_40_boundaries(kw, overflow_every,
                                                 eig_every):
    """Bits, periods, qsteps and the blend ratio after every boundary,
    with overflow steps (which consume no budget unless the blend is on)
    and eigenvalue-scaled periods."""
    jq, tq = JQuantizer(**kw), Quantizer(**kw)
    rs = np.random.RandomState(0)
    for step in range(1, 41):
        overflow = bool(overflow_every) and step % overflow_every == 0
        eig = None
        if eig_every and step % eig_every == 0:
            eig = list(rs.uniform(0.1, 4.0, size=kw.get("layer_num", 1)))
        jq.quantize_tree({}, overflow=overflow, eigenvalues=eig)
        assert tq.quantize_tree({}, overflow=overflow,
                                eigenvalues=eig) == []
        assert _state(tq) == _state(jq), step
        assert tq.any_precision_switch() == jq.any_precision_switch()


def test_schedule_of_the_chip_config():
    """The train_moq phase's schedule (start 16, target 8, period 6,
    offset 0): the bits after each of 12 boundaries."""
    q = Quantizer(q_start_bits=16, q_target_bits=8, q_period=6)
    bits = []
    for _ in range(12):
        q.advance()
        bits.append(q.q_start_bits[0])
    assert bits == [15, 14, 14, 13, 13, 13, 13, 12, 12, 12, 12, 12]


# -- quantize_tree ------------------------------------------------------------

QUANT_CASES = [  # (q_type, groups, layer_num, mixed)
    (0, 1, 0, False), (1, 8, 2, False), (0, 8, 2, True), (1, 1, 0, True)]


@pytest.mark.parametrize("q_type,groups,layer_num,mixed", QUANT_CASES)
@pytest.mark.parametrize("scan_layers", [True, False])
def test_quantize_tree_matches_jax_leaf_for_leaf(scan_layers, q_type, groups,
                                                 layer_num, mixed):
    """Two boundaries of nearest rounding (9 → 8 → 7 bits, the blend at
    0.75 then 0.5) on the JAX init plus noise (so that no bias is zero):
    every leaf bit for bit, and the same leaves quantized."""
    _, params = _jax_params(scan_layers)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_unflatten(treedef, [
        l + jnp.asarray(0.01 * rs.randn(*l.shape), jnp.float32)
        for l in leaves])
    kw = dict(q_start_bits=9, q_target_bits=4, q_period=1, q_groups=groups,
              q_type=q_type, q_mixed_fp16=mixed, q_change_ratio=0.25,
              layer_num=layer_num)
    jq, tq = JQuantizer(**kw), Quantizer(**kw)
    model = _port_model(scan_layers)
    named = model.from_jax_tree(_np32(params))
    before = {k: v.clone() for k, v in named.items()}
    jtree = params
    for _ in range(2):
        jtree = jq.quantize_tree(jtree)
        changed = tq.quantize_tree(named, model.jax_paths())
    want = model.from_jax_tree(_np32(jtree))
    for name, t in named.items():
        _bits_equal(t, want[name], name)
    moved = {n for n in named if not torch.equal(named[n], before[n])}
    assert moved == set(changed)
    eligible = {n for n in named if n.endswith("kernel") or n in ("wte",
                                                                   "wpe")}
    if scan_layers:
        # the kernels are 3-D stacked leaves; the stacked [L, .] biases
        # and LayerNorm parameters are 2-D, and JAX quantizes them
        assert moved == {n for n in named if n.startswith("h.")
                         and not n.endswith("kernel")} | {"wte", "wpe"}
    else:
        assert moved == eligible


def test_quantize_tree_skips_what_jax_skips():
    """16 bits, 1-D leaves and overflow without the blend change nothing;
    stochastic rounding draws from the generator it is given."""
    x = torch.randn(8, 8)
    q = Quantizer(q_start_bits=17, q_target_bits=16, q_period=1)
    named = {"w": x.clone(), "b": torch.randn(8)}
    assert q.quantize_tree(named) == [] and torch.equal(named["w"], x)
    q = Quantizer(q_start_bits=4, q_target_bits=4, q_period=1,
                  q_rounding=1)
    assert q.quantize_tree(named, overflow=True) == [] and q.qsteps == 0
    a, b = {"w": x.clone()}, {"w": x.clone()}
    q.quantize_tree(a, generator=torch.Generator().manual_seed(1))
    q.quantize_tree(b, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], x)
    assert len(torch.unique(a["w"])) <= 16


# -- the engine ---------------------------------------------------------------

def _config(**over):
    """tests/test_torch_training.py's config at gas 1 (its LR warmup keeps
    Adam's first, sign-like steps small: at a full lr from step 0 a
    gradient element near Adam's eps moves the two packages' weights
    apart by more than 2e-5, with or without MoQ)."""
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 1,
           "steps_per_print": 100, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"total_num_steps": 8,
                                    "warmup_num_steps": 2,
                                    "warmup_max_lr": 3e-3,
                                    "warmup_type": "linear"}}}
    cfg.update(over)
    return cfg


MOQ = {"enabled": True,
       "quantize_bits": {"start_bits": 9, "target_bits": 6},
       "quantize_schedule": {"quantize_period": 1, "schedule_offset": 1},
       "quantize_groups": 8,
       "quantize_algo": {"q_type": "symmetric", "rounding": "nearest"}}


def _port_engine(cfg, params, scan_layers=False):
    model = _port_model(scan_layers)
    te, _, _, _ = dst.initialize(
        config=cfg, model=model,
        model_parameters=model.from_jax_tree(_np32(params)), device="cpu")
    return te


def _engines(cfg, scan_layers=False):
    from deepspeed_tpu.parallel.mesh import MeshConfig, make_mesh
    jmodel, params = _jax_params(scan_layers)
    je, _, _, _ = dstpu.initialize(
        config=cfg, model=jmodel, model_parameters=params,
        mesh=make_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    return je, _port_engine(cfg, params, scan_layers)


def _close_or_one_code(te, je, bits):
    """Masters within fp32 2e-5 of JAX's, except that a quantized weight
    may sit one code unit (of its group, at ``bits``) away on under 0.1 %
    of the quantized elements: a last-bit difference in an Adam update can
    cross a rounding boundary."""
    want = te.module.from_jax_tree(_np32(jax.device_get(je.state.params)))
    groups, n_bad, n_all = MOQ["quantize_groups"], 0, 0
    for name, m in zip(te.param_names, te.master):
        w = want[name]
        bad = (m - w).abs() > 2e-5 + 2e-5 * w.abs()
        n_all += m.numel()
        if not bad.any():
            continue
        g = groups if m.numel() % groups == 0 else 1
        code = m.reshape(g, -1).abs().amax(-1, keepdim=True) \
            / (2 ** (bits - 1) - 1)
        diff = (m - w).abs().reshape(g, -1)
        assert bool((diff <= 1.01 * code).all()), name
        n_bad += int(bad.sum())
    assert n_bad < 1e-3 * n_all, (n_bad, n_all)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_moq_train_batch_matches_jax_engine(scan_layers):
    """5 fp32 steps with MoQ from step 1 (9 → 8 → 7 → 6 bits, 8 groups):
    losses at 2e-5, the schedule, and the masters (one-code allowance)."""
    cfg = _config(quantize_training=MOQ)
    je, te = _engines(cfg, scan_layers)
    for i in range(5):
        batch = {"input_ids": _ids(seed=i)}
        lj = float(je.train_batch(batch))
        assert float(te.train_batch(batch)) == pytest.approx(lj, rel=2e-5)
        assert _state(te.quantizer) == _state(je.quantizer)
    assert te.quantizer.q_start_bits == [6]
    _close_or_one_code(te, je, 6)


def test_moq_forward_backward_step_quantizes_at_the_boundary():
    """forward/backward/step with gas 2: MoQ runs once per optimizer
    step, as train_batch runs it."""
    cfg = _config(quantize_training=MOQ, gradient_accumulation_steps=2)
    params = _jax_params(False)[1]
    te, t2 = _port_engine(cfg, params), _port_engine(cfg, params)
    ids = _ids()
    for _ in range(3):
        te.train_batch({"input_ids": ids})
        for i in range(2):
            t2.backward(t2.forward({"input_ids": ids[2 * i:2 * i + 2]}))
            t2.step()
    assert _state(t2.quantizer) == _state(te.quantizer)
    for a, b in zip(te.master, t2.master):
        assert_close(a, b)


def test_moq_stochastic_blend_and_pld_run_on_the_port():
    """The train_moq_sr configuration on the tiny model: asymmetric
    stochastic rounding, the blend falling 0.75 → 0.5 → 0.25 → 0 → 0,
    PLD on; finite losses and the compute copy equal to the masters."""
    moq = dict(MOQ, quantize_algo={"q_type": "asymmetric",
                                   "rounding": "stochastic"},
               fp16_mixed_quantize={"enabled": True,
                                    "quantize_change_ratio": 0.25})
    moq["quantize_schedule"] = {"quantize_period": 6, "schedule_offset": 0}
    moq["quantize_bits"] = {"start_bits": 16, "target_bits": 8}
    cfg = _config(quantize_training=moq, bf16={"enabled": True},
                  data_types={"grad_dtype": "bf16"},
                  progressive_layer_drop={"enabled": True, "theta": 0.5,
                                          "gamma": 0.001})
    model = tgpt2.GPT2LMHeadModel(tgpt2.gpt2_tiny(vocab_size=VOCAB))
    te, _, _, _ = dst.initialize(config=cfg, model=model, device="cpu")
    ratios = []
    for i in range(5):
        assert np.isfinite(float(te.train_batch({"input_ids": _ids(seed=i)})))
        ratios.append(te.quantizer.quantize_real_ratio)
    assert ratios == [0.75, 0.5, 0.25, 0.0, 0.0]
    for p, m in zip(te.compute_params, te.master):
        assert torch.equal(p.data, m.to(torch.bfloat16))


# -- progressive layer drop ---------------------------------------------------

def test_pld_theta_matches_jax():
    for theta, gamma in ((0.5, 0.001), (0.3, 0.1)):
        j, t = JPLD(theta, gamma), ProgressiveLayerDrop(theta, gamma)
        for step in (0, 1, 7, 1000, 123456):
            got = t.theta_at(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(j.theta_at(step)),
                                               rel=2e-7)


def test_pld_train_batch_matches_jax_engine():
    cfg = _config(progressive_layer_drop={"enabled": True, "theta": 0.5,
                                          "gamma": 0.1})
    je, te = _engines(cfg)
    for i in range(5):
        batch = {"input_ids": _ids(seed=i)}
        assert float(te.train_batch(batch)) == pytest.approx(
            float(je.train_batch(batch)), rel=2e-5)
    want = te.module.from_jax_tree(_np32(jax.device_get(je.state.params)))
    for name, m in zip(te.param_names, te.master):
        assert_close(m, want[name])


def test_block_keep_prob_scales_both_sublayers():
    model = _port_model(False)
    model.load_state_dict(model.from_jax_tree(_np32(_jax_params(False)[1])))
    x = torch.randn(2, SEQ, 64)
    block = model.h[0]
    y = x + 0.25 * block.attn(block.ln_1(x))
    assert_close(block(x, torch.tensor(0.25)),
                 y + 0.25 * block.mlp(block.ln_2(y)))
    assert torch.equal(block(x, 1.0), block(x, torch.tensor(1.0)))


# -- eigenvalues --------------------------------------------------------------

def _loss_pair(scan_layers):
    jmodel, params = _jax_params(scan_layers)
    ids = _ids()

    def jloss(p):
        return jgpt2.lm_loss(jmodel.apply({"params": p}, ids), ids)
    model = _port_model(scan_layers)
    model.load_state_dict(model.from_jax_tree(_np32(params)))
    tids = torch.from_numpy(ids).long()

    def tloss():
        return tgpt2.lm_loss(model(tids), tids)
    return params, jloss, model, tloss


def test_hvp_matches_jax():
    params, jloss, model, tloss = _loss_pair(False)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    vec = jax.tree_util.tree_unflatten(
        treedef, [jax.random.normal(k, l.shape, jnp.float32)
                  for k, l in zip(keys, leaves)])
    want = model.from_jax_tree(_np32(JEigenvalue().hvp(jloss, params, vec)))
    v = model.from_jax_tree(_np32(vec))
    names = [n for n, _ in model.named_parameters()]
    got = Eigenvalue.hvp(tloss, list(model.parameters()),
                         [v[n] for n in names])
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in zip(names, got):
        assert_close(g, want[name], atol=2e-5 * scale)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_layer_eigenvalues_match_jax_from_its_start_vectors(scan_layers):
    """JAX's blocks (h_0, h_1 unrolled; ln_1, ln_2 of the stacked block
    under scan, whose names end in a digit), 10 power iterations from
    JAX's own start vectors: within 1e-3 relative."""
    params, jloss, model, tloss = _loss_pair(scan_layers)
    rng = jax.random.PRNGKey(5)
    jev = JEigenvalue(max_iter=10, tol=0.0, layer_num=2)
    want = jev.compute_layer_eigenvalues(jloss, params, rng)
    blocks = jev.find_layer_blocks(params)
    paths = model.jax_paths()
    start = []
    for i, (_, key_path) in enumerate(blocks):
        sub = params
        for k in key_path:
            sub = sub[k]
        leaves, treedef = jax.tree_util.tree_flatten(sub)
        keys = jax.random.split(jax.random.fold_in(rng, i), len(leaves))
        v = jax.tree_util.tree_unflatten(
            treedef, [jax.random.normal(k, l.shape, jnp.float32)
                      for k, l in zip(keys, leaves)])
        tree = {}
        node = tree
        for k in key_path[:-1]:
            node = node.setdefault(k, {})
        node[key_path[-1]] = _np32(v)
        vecs = {}
        for name, (path, layer) in paths.items():
            if list(path[:len(key_path)]) != list(key_path):
                continue
            leaf = tree
            for k in path:
                leaf = leaf[k]
            t = torch.from_numpy(np.array(leaf))
            vecs[name] = t if layer is None else t[layer]
        start.append(vecs)
    named = dict(model.named_parameters())
    got = Eigenvalue(max_iter=10, tol=0.0, layer_num=2) \
        .compute_layer_eigenvalues(tloss, named, paths, start=start)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-3)


def test_config_blocks_match_jax():
    from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig
    moq = dict(MOQ, fp16_mixed_quantize={"enabled": True,
                                         "quantize_change_ratio": 0.25},
               quantize_verbose=True, quantizer_kernel=False,
               eigenvalue={"enabled": True, "max_iter": 7, "tol": 0.5,
                           "stability": 1e-3, "gas_boundary_resolution": 2,
                           "layer_name": "h", "layer_num": 3})
    for cfg in (_config(), _config(quantize_training=moq,
                                   progressive_layer_drop={
                                       "enabled": True, "theta": 0.3,
                                       "gamma": 0.01})):
        j, t = JConfig(cfg), DeepSpeedConfig(cfg)
        assert vars(t.pld_config) == vars(j.pld_config)
        assert vars(t.quantize_training_config) == \
            vars(j.quantize_training_config)


# -- second derivatives through the attention Functions -----------------------

def test_attention_functions_refuse_a_second_derivative():
    """Their backwards carry no graph (lse is made inside forward; on the
    card the kernels' outputs carry none), and ``once_differentiable``
    alone lets a Hessian-vector product run on without the attention's
    terms. Building a graph through either backward raises; a first
    derivative does not."""
    from deepspeed_tpu_torch.ops.attention import FlashAttentionFunction
    from deepspeed_tpu_torch.ops.cuda import blocksparse as bs
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 32, 64, generator=g)
    w = (0.1 * torch.randn(64, 64, generator=g)).requires_grad_()
    tables = bs.layout_tables(np.ones((1, 2, 2), np.int64), 32, 16, 2,
                              "cpu")

    def flash():
        q = x @ w
        return FlashAttentionFunction.apply(q, q, q, True).square().sum()

    def sparse():
        q = (x @ w).reshape(2, 32, 64)
        return bs.BlockSparseAttentionFunction.apply(
            q, q, q, tables, 0.125).square().sum()
    for loss in (flash, sparse):
        assert torch.autograd.grad(loss(), w)[0].abs().sum() > 0
        with pytest.raises(RuntimeError, match="Second derivatives"):
            torch.autograd.grad(loss(), w, create_graph=True)
        with pytest.raises(RuntimeError, match="Second derivatives"):
            Eigenvalue.hvp(loss, [w], [torch.ones_like(w)])
