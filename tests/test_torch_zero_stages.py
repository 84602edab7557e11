"""deepspeed_tpu_torch's ZeRO stages 0-2 at world size n vs the JAX
package, on the CPU.

The bucket plan and the moment shard plan against JAX's on GPT-2 tiny's
and GPT-2 large's shapes; the bucket stream (``bucketed_allreduce``, the
port's one ring form) over gloo against JAX's ring and psum modes inside
``shard_map``; then tiny GPT-2 trained by ``initialize(mesh=...)`` in
gloo worlds of 2 and 4 processes at stages 0, 1 and 2, overlap_comm on
and off, at a bucket of 100 elements (several buckets, a padded tail)
and at the default, against the JAX engine's fused GSPMD path and its
overlap path on 2 and 4 CPU devices: three steps' losses and the
updated masters at rtol 2e-5. At 2 ranks also gas 2, forward / backward
/ step, fp16 with a user loss_fn and an overflow on one rank's rows (the
step skipped on every rank, the scale halved) and eval_batch. Then the
per-rank checkpoints: a 4-rank save resumed at 4 (bit for bit), 2 and 1
rank, and by the JAX engine on 4 devices and on one; a JAX dp-4 save
resumed at 4 ranks; the ZeRO-3 prefetch path saved and resumed at 2.
The config carries the LR warmup of the other training tests (at full
lr Adam's first step parts the packages by more than 2e-5). JAX is
imported inside the tests, so the gpu test runs where it is not
installed.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import torch_zero_stages_worker as worker
from deepspeed_tpu_torch.parallel import overlap as toverlap
from deepspeed_tpu_torch.parallel.mesh import spawn
from deepspeed_tpu_torch.runtime.zero import partition as tpart
from torch_port_common import cuda_device  # noqa: F401

RTOL, ATOL = 2e-5, 1e-5
SEQ, VOCAB, STEPS = 16, 512, 3
MODEL_KW = {"dtype": torch.float32, "n_positions": SEQ}
STAGES = (0, 1, 2)
BUCKETS = {"b100": 100, "default": None}


def _gpt2_shapes(E, L, V, P):
    """GPT-2's leaves in the scan layout, in the JAX tree's leaf order
    (flax sorts the keys): name → shape."""
    F3, F4 = 3 * E, 4 * E
    layer = {"attn/c_attn/bias": (L, F3), "attn/c_attn/kernel": (L, E, F3),
             "attn/c_proj/bias": (L, E), "attn/c_proj/kernel": (L, E, E),
             "ln_1/bias": (L, E), "ln_1/scale": (L, E),
             "ln_2/bias": (L, E), "ln_2/scale": (L, E),
             "mlp/c_fc/bias": (L, F4), "mlp/c_fc/kernel": (L, E, F4),
             "mlp/c_proj/bias": (L, E), "mlp/c_proj/kernel": (L, F4, E)}
    shapes = {f"h/blk/{k}": v for k, v in layer.items()}
    shapes.update({"ln_f/bias": (E,), "ln_f/scale": (E,), "wpe": (P, E),
                   "wte": (V, E)})
    return shapes


SHAPES = {"tiny": _gpt2_shapes(64, 2, 512, 64),
          "large": _gpt2_shapes(1280, 36, 50304, 1024)}


def _cfg(stage, overlap_comm=True, bucket=100, mode="ring", gas=1,
         **more):
    zero = {"stage": stage, "overlap_comm": overlap_comm,
            "overlap_reduce": mode}
    if bucket is not None:
        zero["reduce_bucket_size"] = bucket
    cfg = {"train_batch_size": 8, "gradient_accumulation_steps": gas,
           "steps_per_print": 100, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"total_num_steps": 8,
                                    "warmup_num_steps": 2,
                                    "warmup_max_lr": 1e-3,
                                    "warmup_type": "linear"}},
           "zero_optimization": zero}
    cfg.update(more)
    return cfg


FP16 = {"fp16": {"enabled": True, "initial_scale_power": 8,
                 "hysteresis": 1}}


def _batches(weights=False):
    """STEPS training batches and the next one; with ``weights`` each
    carries the user loss's row weights ``w``, the second an inf in row
    5 (the second rank's rows at world size 2)."""
    out = []
    for i in range(STEPS + 1):
        b = {"input_ids": np.random.RandomState(i).randint(
            0, VOCAB, (8, SEQ)).astype(np.int32)}
        if weights:
            w = (1.0 + 0.1 * np.arange(8)).astype(np.float32)
            if i == 1:
                w[5] = np.inf
            b["w"] = w
        out.append(b)
    return out


def _jax():
    jax = importlib.import_module("jax")
    return (jax, importlib.import_module("jax.numpy"),
            importlib.import_module("deepspeed_tpu"),
            importlib.import_module("deepspeed_tpu.models.gpt2"),
            importlib.import_module("deepspeed_tpu.parallel.mesh"))


def _jax_model():
    jax, jnp, _, jgpt2, _ = _jax()
    cfg = jgpt2.GPT2Config(vocab_size=VOCAB, n_positions=SEQ, n_embd=64,
                           n_layer=2, n_head=2, dtype=jnp.float32,
                           param_dtype=jnp.float32, scan_layers=True)
    return jgpt2.GPT2LMHeadModel(cfg)


def _bridge():
    from deepspeed_tpu_torch.models import gpt2
    return gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(**MODEL_KW))


def _by_name(tree):
    """A JAX tree (device or numpy) → {port name: numpy fp32}."""
    jax = _jax()[0]
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jax.device_get(tree))
    return {k: v.numpy() for k, v in _bridge().from_jax_tree(tree).items()}


def _jax_params():
    jax, jnp = _jax()[:2]
    params = _jax_model().init(jax.random.PRNGKey(0),
                               jnp.zeros((1, SEQ), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_engine(n, cfg, params, loss_fn=None):
    jax, _, dstpu, _, jmesh = _jax()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=n),
                           devices=jax.devices()[:n])
    jax_params = jax.tree_util.tree_map(np.array, params)
    engine, _, _, _ = dstpu.initialize(config=cfg, model=_jax_model(),
                                       model_parameters=jax_params,
                                       mesh=mesh, loss_fn=loss_fn)
    return engine


def _jax_weighted_loss(params, batch):
    jgpt2 = _jax()[3]
    ids = batch["input_ids"]
    logits = _jax_model().apply({"params": params}, ids)
    return jgpt2.lm_loss(logits * batch["w"][:, None, None], ids)


def _jax_train(n, cfg, params, batches, loss_fn=None, save_dir=None):
    """The JAX engine's run: (losses, masters by port name, overlap path
    active, loss scales, the next batch's loss after a save when
    ``save_dir``)."""
    engine = _jax_engine(n, cfg, params, loss_fn)
    losses, scales = [], []
    for b in batches[:STEPS]:
        losses.append(float(engine.train_batch(b)))
        scales.append(float(engine.state.scaler["loss_scale"]))
    masters = _by_name(engine.state.params)
    nxt = None
    if save_dir is not None:
        engine.save_checkpoint(save_dir, tag="t")
        nxt = float(engine.train_batch(batches[STEPS]))
    return losses, masters, engine._overlap_comm_active(), scales, nxt


def _jax_resume(n, ckpt_dir, params, nxt):
    engine = _jax_engine(n, _cfg(2), params)
    engine.load_checkpoint(ckpt_dir)
    return float(engine.train_batch(nxt)), engine.global_steps


# -- the worlds: every spawned run, once a module ---------------------------

def _cases(n):
    """The port's train cases: at 2 ranks every (stage, overlap_comm,
    bucket), gas 2 and forward/backward/step; at 4 each stage once, on
    and off, at both buckets; at both ``overlap_reduce: "fused"``, which
    runs the same ring form as ``s2_on_b100``."""
    grid = [(s, on, b) for s in STAGES for on in (True, False)
            for b in BUCKETS]
    if n == 4:
        grid = [(0, True, "b100"), (1, False, "default"),
                (2, True, "b100"), (2, False, "default")]
    cases = [(f"s{s}_{'on' if on else 'off'}_{b}", _cfg(s, on, BUCKETS[b]),
              "train") for s, on, b in grid]
    cases.append(("s2_fused", _cfg(2, mode="fused"), "train"))
    if n == 2:
        cases += [("gas2", _cfg(2, gas=2), "train"),
                  ("fwd_bwd_step", _cfg(2, gas=2), "fwd_bwd_step"),
                  ("loss_fn", _cfg(2, False, **FP16), "loss_fn")]
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's baselines and saves, the 4-rank world, the 2-rank world and
    the cross-package resumes, in the order their checkpoints need; each
    world runs in the background while the parent runs JAX."""
    from concurrent.futures import ThreadPoolExecutor
    root = tmp_path_factory.mktemp("zero_stages")
    params = _jax_params()
    state = _by_name(params)
    batches, weighted = _batches(), _batches(weights=True)
    nxt, port4, jax4 = batches[STEPS], str(root / "port4"), \
        str(root / "jax4")
    ckpt_cfg = _cfg(2, bucket=None)
    jx = {(4, "fused_s2"): _jax_train(4, _cfg(2, False), params, batches,
                                      save_dir=jax4)}
    pool = ThreadPoolExecutor(1)
    four = pool.submit(spawn, worker.run_jobs, 4, [
        ("train_cases", _cases(4), state, batches[:STEPS], MODEL_KW),
        ("save_and_resume", ckpt_cfg, state, batches[:STEPS], nxt, port4,
         MODEL_KW),
        ("resume", ckpt_cfg, state, jax4, nxt, MODEL_KW)])
    jx[(4, "overlap_s2_ring")] = _jax_train(4, _cfg(2), params, batches)
    jx[(2, "fused_s0")] = _jax_train(2, _cfg(0, False), params, batches)
    jx[(2, "overlap_s1_ring")] = _jax_train(2, _cfg(1), params, batches)
    jx[(2, "overlap_s2_fused")] = _jax_train(2, _cfg(2, mode="fused"),
                                             params, batches)
    jx[(2, "gas2")] = _jax_train(2, _cfg(2, False, gas=2), params, batches)
    jx[(2, "loss_fn")] = _jax_train(2, _cfg(2, False, **FP16), params,
                                    weighted, loss_fn=_jax_weighted_loss)
    jax_logits = np.asarray(_jax_model().apply(
        {"params": params}, batches[0]["input_ids"]))
    four = four.result()
    zero3 = _cfg(3, **{"zero_optimization": {
        "stage": 3, "stage3_prefetch": True,
        "stage3_param_persistence_threshold": 0,
        "collective_matmul": {"min_shard_bytes": 0}}})
    cases = _cases(2)
    two = pool.submit(spawn, worker.run_jobs, 2, [
        ("train_cases", cases[:-1], state, batches[:STEPS], MODEL_KW),
        ("train_cases", cases[-1:], state, weighted[:STEPS], MODEL_KW),
        ("eval_logits", _cfg(2), state, batches[0]["input_ids"], MODEL_KW),
        ("resume", ckpt_cfg, state, port4, nxt, MODEL_KW),
        ("save_and_resume", zero3, state, batches[:2], batches[2],
         str(root / "zero3"), MODEL_KW)])
    jax_resumed = {n: _jax_resume(n, port4, params, nxt) for n in (4, 1)}
    two = two.result()
    pool.shutdown()
    return {"jax": jx, "four": four, "two": two, "state": state,
            "params": params, "batches": batches, "port4": port4,
            "jax_logits": jax_logits, "jax_resumed": jax_resumed}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _masters_close(got, want, what):
    assert set(got) == set(want), what
    for name in want:
        _close(got[name], want[name], f"{what} {name}")


# -- plans -------------------------------------------------------------------

@pytest.mark.parametrize("model", ["tiny", "large", "odd"])
@pytest.mark.parametrize("bucket", [100, int(5e8)])
def test_bucket_plan_matches_jax(model, bucket):
    """plan_buckets over the JAX tree's leaves in order (and over odd
    sizes), at 2, 4 and 8 ranks: the same buckets (leaf ids, sizes,
    padded length). At 100 every GPT-2 leaf is oversized and takes a
    bucket alone; the odd sizes pack and pad their tails."""
    joverlap = importlib.import_module("deepspeed_tpu.parallel.overlap")
    shapes = list(SHAPES[model].values()) if model in SHAPES else \
        [(37,), (130,), (3, 5), (2,), (11, 3), ()]
    for n in (2, 4, 8):
        got = toverlap.plan_buckets(shapes, bucket, n)
        want = joverlap.plan_buckets(shapes, bucket, n)
        assert [(b.leaf_ids, b.sizes, b.padded) for b in got] == \
            [(b.leaf_ids, b.sizes, b.padded) for b in want]
        assert all(b.padded % n == 0 and 0 <= b.padded - b.numel < n
                   for b in got)
    if model == "odd":
        assert any(b.padded > b.numel for b in got)
    elif bucket == 100:
        assert all(len(b.leaf_ids) == 1 for b in got)


@pytest.mark.parametrize("model", ["tiny", "large"])
@pytest.mark.parametrize("stage", [1, 2])
def test_moment_shard_plan_matches_jax(model, stage):
    """explicit_shard_plan (the moment specs by default) against JAX's
    ZeroPartitioner on an n-device CPU mesh, at 2, 4 and 8 ranks, with
    the persistence threshold JAX passes below stage 3 (0); the grad and
    param specs by stage."""
    jax = importlib.import_module("jax")
    jpart = importlib.import_module("deepspeed_tpu.runtime.zero.partition")
    jmesh = importlib.import_module("deepspeed_tpu.parallel.mesh")
    shapes = SHAPES[model]
    tree = {}
    for name, shape in shapes.items():
        node = tree
        *head, last = name.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = jax.ShapeDtypeStruct(shape, np.float32)
    for n in (2, 4, 8):
        mesh = jmesh.make_mesh(jmesh.MeshConfig(data=n),
                               devices=jax.devices()[:n])
        jzero = jpart.ZeroPartitioner(mesh, stage)
        zero = tpart.ZeroPartitioner(n, stage)
        want = jzero.explicit_shard_plan(tree)
        assert zero.explicit_shard_plan(shapes) == want, (model, n)
        jleaves = jax.tree_util.tree_leaves(
            jzero.grad_specs(tree),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert [tuple(s) for s in jleaves] == \
            list(zero.grad_specs(shapes).values())
        assert all(set(s) == {None} for s in
                   zero.param_specs(shapes).values())
    if model == "large" and stage == 2:
        plan = dict(zip(shapes, tpart.ZeroPartitioner(4, 2)
                        .explicit_shard_plan(shapes)))
        assert plan["wte"] == (0, 50304 // 4)
        assert plan["h/blk/attn/c_attn/kernel"] == (2, 3840 // 4)
        assert plan["ln_f/scale"] == (0, 320)


def test_zero_config_bucket_knobs_carry_the_jax_messages():
    JConfig = importlib.import_module(
        "deepspeed_tpu.config.config").DeepSpeedConfig
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig
    for zero in ({"stage": 2, "overlap_reduce": "tree"},
                 {"stage": 2, "overlap_comm": True,
                  "reduce_bucket_size": 0}):
        cfg = {"train_batch_size": 8, "zero_optimization": zero}
        with pytest.raises(ValueError) as want:
            JConfig(cfg)
        with pytest.raises(ValueError) as got:
            DeepSpeedConfig(cfg, world_size=2)
        assert str(got.value) == str(want.value)
    # both keys accepted for parity (the port runs the ring form whatever
    # overlap_reduce says)
    cfg = {"train_batch_size": 8, "zero_optimization": {
        "stage": 2, "allgather_bucket_size": 1000,
        "overlap_reduce": "fused"}}
    assert DeepSpeedConfig(cfg, world_size=2).zero_config.reduce_bucket_size \
        == JConfig(cfg).zero_config.reduce_bucket_size
    default = DeepSpeedConfig({"train_batch_size": 8}, world_size=2)
    assert default.zero_config.reduce_bucket_size == \
        JConfig({"train_batch_size": 8}).zero_config.reduce_bucket_size


def test_what_stages_0_2_do_not_run_at_world_n_raises_naming_roadmap():
    """MoQ at world n, a non-elementwise optimizer: refused before any
    collective, naming the ROADMAP item; the offload tiers at world n in
    the config."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer
    from deepspeed_tpu_torch.parallel.mesh import Mesh
    moq = {"enabled": True, "quantize_bits": {"start_bits": 16,
                                              "target_bits": 8}}
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        ds.initialize(config=_cfg(1, quantize_training=moq),
                      model=gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny()),
                      mesh=Mesh(2, 0, "cpu"))

    class Layerwise(TorchOptimizer):
        pass
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        ds.initialize(config=_cfg(2), optimizer=Layerwise(),
                      model=gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny()),
                      mesh=Mesh(2, 0, "cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        DeepSpeedConfig(_cfg(2, zero_optimization={
            "stage": 2, "offload_optimizer": {"device": "cpu"}}),
            world_size=2)


# -- the bucket stream -------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_bucket_streams_match_jax_in_shard_map(n):
    """Each rank's own leaves (bucket 100: several buckets, an oversized
    leaf alone, a padded tail): the port's ring all-reduce means against
    JAX's ring and fused (psum) modes inside shard_map on n devices."""
    jax, jnp = _jax()[:2]
    joverlap = importlib.import_module("deepspeed_tpu.parallel.overlap")
    jmesh = importlib.import_module("deepspeed_tpu.parallel.mesh")
    P = jax.sharding.PartitionSpec
    shapes = [(7, 9), (130,), (3, 5), (2,), (11, 3)]
    seed = 11
    got = spawn(worker.bucket_streams, n, shapes, 100, seed)
    per_rank = []
    for r in range(n):
        rs = np.random.RandomState(seed + r)
        per_rank.append([rs.randn(*s).astype(np.float32) for s in shapes])
    stacked = [np.stack([per_rank[r][i] for r in range(n)])
               for i in range(len(shapes))]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))

    def run(fn):
        @jax.jit
        def go(xs):
            return jmesh.shard_map(
                lambda *ls: fn([x[0] for x in ls]), mesh=mesh,
                in_specs=tuple(P("data") for _ in xs),
                out_specs=P("data"), check_vma=False)(*xs)
        return go(tuple(jnp.asarray(x) for x in stacked))

    for mode in ("ring", "fused"):
        out = run(lambda ls: [x[None] for x in joverlap.bucketed_allreduce(
            ls, "data", n, 100, mode=mode)])
        for i, want in enumerate(out):
            want = np.asarray(want)
            for r in range(n):
                _close(got[r][i], want[r], f"{mode} leaf {i} rank {r}")


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("stage", STAGES)
def test_stage_trajectories_match_the_jax_fused_and_overlap_paths(runs, n,
                                                                 stage):
    """Every (overlap_comm, bucket) case at the stage: the losses and the
    updated masters of three steps against the JAX engine's fused path
    and its overlap path (ring and psum modes); every rank reports the
    same losses. ``overlap_reduce: "fused"`` trains bit for bit as the
    ring case it differs from in that key alone."""
    jx = runs["jax"]
    world = runs["two"] if n == 2 else runs["four"]
    cases = world[0][0]
    baselines = [k for k in jx if k[0] == n and not k[1].startswith(
        ("gas2", "loss_fn"))]
    assert any(not jx[k][2] for k in baselines)       # the fused path
    assert any(jx[k][2] for k in baselines)           # the overlap path
    names = [c for c in cases if c.startswith(f"s{stage}_")]
    assert names == [c for c, _, _ in _cases(n) if c.startswith(f"s{stage}_")]
    assert names
    for name in names:
        losses, masters = cases[name][:2]
        for key in baselines:
            want_losses, want = jx[key][:2]
            _close(losses, want_losses, f"{name} vs {key}")
            _masters_close(masters, want, f"{name} vs {key}")
        for rank in world[1:]:
            assert rank[0][name][0] == losses
    if stage == 2:
        fused, ring = cases["s2_fused"], cases["s2_on_b100"]
        assert fused[0] == ring[0]
        assert all(np.array_equal(fused[1][k], ring[1][k]) for k in ring[1])


@pytest.mark.parametrize("n", [2, 4])
def test_bucket_and_moment_plans_on_the_engine(runs, n):
    """At bucket 100 every leaf of GPT-2 tiny but the small ones takes a
    bucket of its own; the default puts them all in one. Stage 0 steps
    every leaf whole, stages 1 and 2 cut the moments of every leaf a
    dimension of which n divides (``explicit_shard_plan``)."""
    cases = (runs["two"] if n == 2 else runs["four"])[0][0]
    state = runs["state"]
    shapes = {k: v.shape for k, v in state.items()}
    assert cases["s2_off_default"][2] == [tuple(range(len(shapes)))]
    small = cases["s2_on_b100"][2]
    assert len(small) > 10
    assert [i for ids in small for i in ids] == list(range(len(shapes)))
    assert all(e is None for e in cases["s0_on_b100"][3])
    assert cases["s1_off_default"][3] == cases["s2_on_b100"][3]
    cut = [e for e in cases["s2_on_b100"][3] if e is not None]
    assert len(cut) == len(shapes)          # every leaf has a dimension n
    assert all(e[1] > 0 for e in cut)       # of GPT-2 tiny divides


def test_gas2_and_forward_backward_step_match_jax(runs):
    """gas 2 at 2 ranks (a rank's micro batches are its rows cut in two;
    JAX cuts the global batch first: the same rows in all), through
    train_batch and through forward/backward/step; forward returns the
    micro batch's loss, the mean over the ranks."""
    cases = runs["two"][0][0]
    want_losses, want = runs["jax"][(2, "gas2")][:2]
    for name in ("gas2", "fwd_bwd_step"):
        losses, masters = cases[name][:2]
        _close(losses, want_losses, name)
        _masters_close(masters, want, name)
    fwd = cases["fwd_bwd_step"][5]
    assert len(fwd) == 2 * STEPS and all(np.isfinite(fwd))
    _close([(a + b) / 2 for a, b in zip(fwd[::2], fwd[1::2])],
           cases["fwd_bwd_step"][0], "forward losses")


def test_fp16_overflow_on_one_rank_with_a_user_loss_fn_matches_jax(runs):
    """A user loss_fn (logits scaled row by row) under fp16: the second
    step's inf lies in the second rank's rows alone, yet every rank skips
    the step and halves the scale; the trajectory and the masters as
    JAX's."""
    losses, masters, _, _, scales = runs["two"][0][1]["loss_fn"][:5]
    want_losses, want, _, want_scales = runs["jax"][(2, "loss_fn")][:4]
    assert np.isnan(losses[1]) and np.isnan(want_losses[1])
    assert scales == want_scales == [256.0, 128.0, 128.0]
    _close(losses, want_losses, "loss_fn losses")
    _masters_close(masters, want, "loss_fn")
    for rank in runs["two"][1:]:
        assert rank[1]["loss_fn"][4] == scales


def test_eval_batch_returns_the_whole_batch_on_every_rank(runs):
    want = runs["jax_logits"]
    for r, logits in enumerate(rank[2] for rank in runs["two"]):
        assert logits.shape == want.shape
        _close(logits, want, f"eval rank {r}")


# -- checkpoints -------------------------------------------------------------

def test_four_rank_save_resumes_at_four_bit_for_bit(runs):
    """Each rank wrote its shard files (the replicated masters from rank
    0 alone); a fresh 4-rank engine resumes with the uninterrupted run's
    next loss, bit for bit."""
    losses, want, got, files = runs["four"][0][1]
    assert got == want
    assert files == sorted(["meta.json"] + [
        f"{stem}_shard_{r}.npz" for stem in ("model_states",
                                             "optim_states")
        for r in range(4)] + [f"shard_index_{r}.json" for r in range(4)])
    for rank in runs["four"][1:]:
        assert rank[1][2] == got


def test_four_rank_save_resumes_at_two_ranks_and_on_one(runs):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import gpt2
    want = runs["four"][0][1][1]
    loss2, steps2, _ = runs["two"][0][3]
    _close(loss2, want, "4 -> 2")
    assert steps2 == STEPS + 1
    engine, _, _, _ = ds.initialize(
        config=_cfg(2, bucket=None), model=gpt2.GPT2LMHeadModel(
            gpt2.gpt2_tiny(**MODEL_KW)), device="cpu")
    engine.load_checkpoint(runs["port4"])
    loss1 = float(engine.train_batch(runs["batches"][STEPS]))
    _close(loss1, want, "4 -> 1")


@pytest.mark.parametrize("n", [4, 1])
def test_the_jax_engine_resumes_a_four_rank_port_save(runs, n):
    want = runs["four"][0][1][1]
    loss, steps = runs["jax_resumed"][n]
    _close(loss, want, f"port 4 -> jax {n}")
    assert steps == STEPS + 1


def test_a_jax_dp4_save_resumes_at_four_ranks(runs):
    _, _, _, _, want = runs["jax"][(4, "fused_s2")]
    for rank in runs["four"]:
        loss, steps, _ = rank[2]
        _close(loss, want, "jax 4 -> port 4")
        assert steps == STEPS + 1
    masters = runs["four"][0][2][2]
    _masters_close(masters, runs["jax"][(4, "fused_s2")][1], "jax 4 masters")


def test_zero3_prefetch_saves_and_resumes_at_two_ranks(runs):
    for rank in runs["two"]:
        losses, want, got, files = rank[4]
        assert all(np.isfinite(losses))
        assert got == want
        assert "shard_index_1.json" in files


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_bucket_exchange_over_a_two_rank_heap_matches_plain(cuda_device):  # noqa: F811
    """Two ranks on the card run the bucket stream through the symmetric
    heap: one mm_rs_reduce launch a bucket, every reduced leaf bit for
    bit as the same exchange with mm_rs_reduce_plain; the updated-slice
    all-gather fills every rank's slices."""
    from deepspeed_tpu_torch.ops.cuda import builder
    builder.kernels()                 # build once before the ranks start
    for equal, launched, buckets, gathered in spawn(
            worker.heap_bucket_exchange, 2, 100):
        assert equal and gathered
        assert buckets > 3
        assert launched == {"mm_rs_reduce": buckets}, launched
