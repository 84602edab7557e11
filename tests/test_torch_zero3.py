"""deepspeed_tpu_torch's ZeRO-3 prefetch path at world size n vs the JAX
package, on the CPU.

The shard choice (``shard_spec_for_leaf``, with its tie-break and the
layer dimension excluded) and the layer plan against JAX's on GPT-2
tiny's and GPT-2 large's shapes; the config's validation messages; then
tiny GPT-2 (``scan_layers=True``) trained by ``initialize(mesh=...)`` →
``train_batch`` in 2 and 4 gloo processes, in ``ring`` and
``fused_matmul`` modes (``min_shard_bytes`` 0, so the four projections
stream at this size, as JAX's tests set it), against the JAX engine's
stage-3 run on a 2- and 4-device mesh with ``stage3_prefetch: false``
(``tests/test_prefetch.py``'s ``_fused_baseline``, to which the JAX
prefetch paths are pinned): 3 steps' losses and the updated parameters
at rtol 2e-5. The config carries the training tests' LR warmup: at full
lr Adam's first step parts the packages by more than that.
"""

import importlib

import numpy as np
import pytest
import torch

import torch_zero3_worker as worker
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.parallel import prefetch as tprefetch
from deepspeed_tpu_torch.parallel.mesh import Mesh, spawn
from deepspeed_tpu_torch.runtime.zero import partition as tpart

RTOL, ATOL = 2e-5, 1e-5
SEQ, VOCAB, STEPS = 64, 512, 3


def _gpt2_shapes(E, L, V, P):
    """GPT-2's resting leaves in the scan layout: name → shape."""
    F3, F4 = 3 * E, 4 * E
    layer = {"attn/c_attn/kernel": (L, E, F3), "attn/c_attn/bias": (L, F3),
             "attn/c_proj/kernel": (L, E, E), "attn/c_proj/bias": (L, E),
             "ln_1/scale": (L, E), "ln_1/bias": (L, E),
             "ln_2/scale": (L, E), "ln_2/bias": (L, E),
             "mlp/c_fc/kernel": (L, E, F4), "mlp/c_fc/bias": (L, F4),
             "mlp/c_proj/kernel": (L, F4, E), "mlp/c_proj/bias": (L, E)}
    shapes = {f"h/{k}": v for k, v in layer.items()}
    shapes.update({"wte": (V, E), "wpe": (P, E), "ln_f/scale": (E,),
                   "ln_f/bias": (E,)})
    return shapes


SHAPES = {"tiny": _gpt2_shapes(64, 2, 512, 64),
          "large": _gpt2_shapes(1280, 36, 50304, 1024)}


def _nested(names, leaf):
    tree = {}
    for name in names:
        node = tree
        *head, last = name.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf(name)
    return tree


def _get(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return tree


class _Leaf:
    def __init__(self, shape):
        self.shape, self.dtype = tuple(shape), np.dtype(np.float32)


@pytest.mark.parametrize("model", ["tiny", "large"])
def test_shard_specs_and_layer_plan_match_jax(model):
    """The port's specs, plans and layer plan against JAX's
    ZeroPartitioner (on an n-device CPU mesh, the layer subtree stacked)
    and build_layer_plan, at n 2, 4 and 8 and thresholds 0 and 1e5."""
    jax = importlib.import_module("jax")
    jpart = importlib.import_module("deepspeed_tpu.runtime.zero.partition")
    jpre = importlib.import_module("deepspeed_tpu.parallel.prefetch")
    jmesh = importlib.import_module("deepspeed_tpu.parallel.mesh")
    shapes = SHAPES[model]
    layer = [k for k in shapes if k.startswith("h/")]
    tree = _nested(shapes, lambda k: jax.ShapeDtypeStruct(shapes[k],
                                                          np.float32))
    for n in (2, 4, 8):
        mesh = jmesh.make_mesh(jmesh.MeshConfig(data=n),
                               devices=jax.devices()[:n])
        for threshold in (0, 100000):
            jzero = jpart.ZeroPartitioner(
                mesh, 3, param_persistence_threshold=threshold)
            jzero.layer_stacked_prefixes = ("h",)
            jspecs = jzero.param_specs(tree)
            zero = tpart.ZeroPartitioner(n, 3, threshold)
            zero.layer_stacked_prefixes = ("h",)
            specs = zero.param_specs(shapes)
            for name in shapes:
                assert specs[name] == tuple(_get(jspecs, name)), \
                    (model, n, threshold, name)
            plan = zero.explicit_shard_plan({k: shapes[k] for k in layer})
            jplan = jpre.plan_from_specs(
                [_Leaf(shapes[k]) for k in layer],
                [_get(jspecs, k) for k in layer], "data", n)
            assert plan == jplan
            kernels = [i for i, k in enumerate(layer)
                       if k.endswith("kernel") and plan[i] is not None]
            lp = tprefetch.build_layer_plan(
                [torch.empty(shapes[k], device="meta") for k in layer],
                plan, n, kernels)
            jlp = jpre.build_layer_plan(
                [_Leaf(shapes[k]) for k in layer], plan, n, kernels)
            assert lp.plan == jlp.plan and lp.fused == jlp.fused
            assert [ids for _, ids in lp.groups] == \
                [ids for _, ids in jlp.groups]
    if model == "large":
        # the kernels' shard dims decide the fused variants (n = 4,
        # stacked coordinates): c_attn and c_fc cut their output dim, both
        # c_proj the contracting one
        spec = {k: tpart.shard_spec_for_leaf(v, 4, min_size=100000,
                                             exclude_dims=(0,))
                for k, v in shapes.items() if k.endswith("kernel")}
        assert spec["h/attn/c_attn/kernel"] == (None, None, "data")
        assert spec["h/mlp/c_fc/kernel"] == (None, None, "data")
        assert spec["h/attn/c_proj/kernel"] == (None, "data", None)
        assert spec["h/mlp/c_proj/kernel"] == (None, "data", None)
        # biases and LayerNorms of [36, 1280] stay replicated at the
        # default persistence threshold; [36, 3840] is cut
        assert tpart.shard_spec_for_leaf((36, 1280), 4, min_size=100000,
                                         exclude_dims=(0,)) == (None, None)
        assert tpart.shard_spec_for_leaf((36, 3840), 4, min_size=100000,
                                         exclude_dims=(0,)) == (None, "data")


@pytest.mark.parametrize("zero", [
    {"stage": 3, "stage3_prefetch_gather": "nope"},
    {"stage": 3, "collective_matmul": [1]},
    {"stage": 3, "collective_matmul": {"backend": "mosaic"}},
    {"stage": 3, "collective_matmul": {"tile_m": 0}},
    {"stage": 3, "collective_matmul": {"min_shard_bytes": -1}},
    {"stage": 3, "collective_matmul": {"vmem_budget_bytes": 0}},
    {"stage": 2, "stage3_prefetch": True},
])
def test_zero_config_errors_carry_the_jax_messages(zero):
    JConfig = importlib.import_module(
        "deepspeed_tpu.config.config").DeepSpeedConfig
    cfg = {"train_batch_size": 8, "zero_optimization": zero}
    with pytest.raises(ValueError) as want:
        JConfig(cfg)
    with pytest.raises(ValueError) as got:
        DeepSpeedConfig(cfg)
    assert str(got.value) == str(want.value)


def test_what_the_n_rank_path_does_not_run_raises_naming_roadmap():
    zero = {"stage": 3, "stage3_prefetch": True}
    for cfg in ({"zero_optimization": dict(zero,
                                           stage3_prefetch_gather="fused")},
                {"zero_optimization": zero,
                 "comm": {"hierarchy": {"slow_axis": 2}}},
                {"mesh": {"data": 2, "model": 2}}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            DeepSpeedConfig(dict(cfg, train_batch_size=8), world_size=2)
    from deepspeed_tpu_torch.config.config import DeepSpeedConfigError
    with pytest.raises(DeepSpeedConfigError, match="mesh.data 4"):
        DeepSpeedConfig({"train_batch_size": 8, "mesh": {"data": 4}},
                        world_size=2)
    # a world of two ranks at stage 3 without prefetch, or with MoQ at
    # stage 2: the engine refuses before any collective
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import gpt2
    moq = {"enabled": True, "quantize_bits": {"start_bits": 16,
                                              "target_bits": 8}}
    for cfg in ({"zero_optimization": {"stage": 3}},
                {"zero_optimization": {"stage": 2},
                 "quantize_training": moq}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            ds.initialize(config=dict(cfg, train_batch_size=8),
                          model=gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny()),
                          mesh=Mesh(2, 0, "cpu"))


def _port_cfg(mode, gas=1, accum="fp32"):
    return {"train_batch_size": 8, "gradient_accumulation_steps": gas,
            "data_types": {"grad_accum_dtype": accum},
            "steps_per_print": 100,
            "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupDecayLR",
                          "params": {"total_num_steps": 8,
                                     "warmup_num_steps": 2,
                                     "warmup_max_lr": 1e-3,
                                     "warmup_type": "linear"}},
            "zero_optimization": {"stage": 3, "stage3_prefetch": True,
                                  "stage3_prefetch_gather": mode,
                                  "stage3_param_persistence_threshold": 0,
                                  "collective_matmul": {
                                      "min_shard_bytes": 0}}}


def _batches():
    return [{"input_ids": np.random.RandomState(i).randint(
        0, VOCAB, (8, SEQ)).astype(np.int32)} for i in range(STEPS)]


def _jax_baseline(n, gas=1):
    """The JAX engine's stage-3 run (prefetch off) on n CPU devices: the
    initial weights by the port's names, the losses and the updated
    weights by the port's names."""
    jax = importlib.import_module("jax")
    jnp = importlib.import_module("jax.numpy")
    dstpu = importlib.import_module("deepspeed_tpu")
    jgpt2 = importlib.import_module("deepspeed_tpu.models.gpt2")
    jmesh = importlib.import_module("deepspeed_tpu.parallel.mesh")
    from deepspeed_tpu_torch.models import gpt2
    jcfg = jgpt2.GPT2Config(vocab_size=VOCAB, n_positions=SEQ, n_embd=64,
                            n_layer=2, n_head=2, dtype=jnp.float32,
                            param_dtype=jnp.float32, scan_layers=True)
    model = jgpt2.GPT2LMHeadModel(jcfg)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, SEQ), jnp.int32))["params"]
    cfg = _port_cfg("ring", gas)
    cfg["zero_optimization"] = {"stage": 3,
                                "stage3_param_persistence_threshold": 0}
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=n),
                           devices=jax.devices()[:n])
    engine, _, _, _ = dstpu.initialize(config=cfg, model=model,
                                       model_parameters=params, mesh=mesh)
    assert not engine._prefetch_active()
    losses = [float(engine.train_batch(b)) for b in _batches()]
    bridge = gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(n_positions=SEQ))

    def by_name(tree):
        tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                      jax.device_get(tree))
        return {k: v.numpy() for k, v in bridge.from_jax_tree(tree).items()}
    return by_name(params), losses, by_name(engine.state.params)


@pytest.mark.parametrize("n", [2, 4])
def test_n_rank_trajectories_match_the_jax_stage3_baseline(n):
    """Both gather modes; at world 2 also fused_matmul with 2
    gradient-accumulation micro batches (a rank's micro batches are not
    JAX's, whose micro batches are cut before the rows are sharded: the
    same rows in all, summed in another order), and the same with
    grad_accum_dtype bf16, which JAX's prefetch path does not read: held
    to the fp32-accumulated run, from which bf16 accumulation must part
    (the setting takes effect) by no more than bf16 rounding."""
    state, want_losses, want = _jax_baseline(n)
    kw = {"dtype": torch.float32, "n_positions": SEQ}
    modes = [(m, _port_cfg(m), kw) for m in ("ring", "fused_matmul")]
    baselines = {m: (want_losses, want) for m, _, _ in modes}
    if n == 2:
        modes.append(("fused_matmul_gas2", _port_cfg("fused_matmul", 2), kw))
        modes.append(("fused_matmul_gas2_bf16acc",
                      _port_cfg("fused_matmul", 2, "bf16"), kw))
        _, gas_losses, gas_want = _jax_baseline(n, gas=2)
        baselines["fused_matmul_gas2"] = (gas_losses, gas_want)
    results = spawn(worker.train_modes, n, modes, state, _batches())
    for mode, (losses, got, stats, refused, freed) in results[0].items():
        # close() leaves no cycle through the engine: its shards go with
        # its last reference
        assert freed, mode
        if mode.endswith("bf16acc"):
            fp32_losses, fp32_got = results[0]["fused_matmul_gas2"][:2]
            assert losses[0] == fp32_losses[0]
            np.testing.assert_allclose(losses, fp32_losses, rtol=1e-3)
            assert losses[1:] != fp32_losses[1:]
            assert any(not np.array_equal(got[k], fp32_got[k])
                       for k in got)
            continue
        want_losses, want = baselines[mode]
        np.testing.assert_allclose(losses, want_losses, rtol=RTOL,
                                   err_msg=mode)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{mode} {name}")
        fused = mode.startswith("fused_matmul")
        assert stats["fused_leaves_per_layer"] == (4 if fused else 0), mode
        assert stats["layers"] == 2
        assert (stats["fused_stream_bytes"] > 0) == fused
        # forward/backward/step on the prefetch path are not ported: they
        # raise
        assert refused, mode
    # every rank reports the same all-reduced losses
    for rank_result in results[1:]:
        for mode, (losses, _, _, _, _) in rank_result.items():
            assert losses == results[0][mode][0]


@pytest.mark.parametrize("n", [2, 4])
def test_layer_batch_matches_the_unbatched_backward_bit_for_bit(n):
    """The backward's layer batch (the streamed leaves' partials and the
    packed groups in one exchange region, one exchange and one reduce a
    layer) gives every shard gradient bit for bit as the backward that
    exchanged each reduce-scatter on its own, in both gather modes; one
    batch closes with an exchange a layer, and the step makes (k - 1)
    fewer exchanges a layer, k the reduce-scatters a layer took before
    (the four streamed leaves and the packed group under fused_matmul;
    the packed group alone under ring)."""
    cfgs = [(m, _port_cfg(m)) for m in ("ring", "fused_matmul")]
    batch = {"input_ids": torch.from_numpy(_batches()[0]["input_ids"])}
    results = spawn(worker.batch_vs_unbatched, n, cfgs, batch)
    for rank_result in results:
        for mode, (equal, batched, unbatched, closes, L, fused,
                   groups) in rank_result.items():
            assert equal, mode
            assert fused == (4 if mode == "fused_matmul" else 0), mode
            assert groups == 1, mode
            assert closes == L, mode
            assert unbatched - batched == L * (fused + groups - 1), mode
