"""deepspeed_tpu_torch's ZeRO stage 3 off the prefetch pipeline (the
gather path, JAX's fused GSPMD stage-3 path) at world size n vs the JAX
package, on the CPU.

The stage-3 plan (``stage3_param_plan``) against JAX's ``param_specs`` on
the JAX trees of GPT-2 tiny and large, LLaMA tiny (both layer layouts)
and BERT tiny, with and without the persistence threshold; then tiny models
trained by ``initialize(mesh=...)`` in gloo worlds of 2 and 4 processes
at ZeRO stage 3 against the JAX engine on ``MeshConfig(data=n)``, on the
same weights and batches: three steps' losses, the updated fp32 masters
and both Adam moments at rtol 2e-5. At 2 ranks: ``stage3_prefetch`` off
with and without ``overlap_comm`` at a 100-element bucket and at the
default, a persistence threshold that the stacked leaves cross and the
per-layer ones do not, gas 2, ``train_batch`` mixed with
``forward``/``backward``/``step`` on a prefetch engine, a user loss_fn
under fp16 with an overflow on one rank's rows, LLaMA tiny, the three
offload tiers (each engine its own ``nvme_path``), fp16 on the prefetch
path from a loss scale at which the first steps overflow; ``eval_batch``
on a prefetch engine returns the whole batch on every rank. At 4 ranks
``stage3_prefetch`` off. Then the checkpoints: a gather-path 2-rank save
resumed at 2 (bit for bit), on the prefetch path, at one rank and by the
JAX engine at data 2; a JAX data-2 stage-3 save resumed by the port;
offload and device-optimizer saves resumed in each other. The config
carries the LR warmup of the other training tests. JAX is imported
inside the tests, so the gpu test runs where it is not installed.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import torch_zero3_gather_worker as worker
from deepspeed_tpu_torch.parallel.mesh import spawn
from deepspeed_tpu_torch.runtime.zero import partition as tpart
from test_torch_zero_offload import HOST, STREAMED, _moments_close, _nvme
from test_torch_zero_stages import (FP16, MODEL_KW, RTOL, SEQ, STEPS,
                                    _batches, _by_name, _cfg, _close, _jax,
                                    _jax_model, _jax_params,
                                    _jax_weighted_loss, _masters_close)
from torch_port_common import cuda_device  # noqa: F401

LLAMA_KW = {"dtype": torch.float32, "scan_layers": True}
MODEL_KWS = {"gpt2": MODEL_KW, "llama": LLAMA_KW}
# fp16 on the prefetch path: at 2**127 the tiny model's scaled gradients
# overflow fp32 in both packages; with hysteresis 3 the three steps are
# skipped and the third halves the scale. Below 2**127 the packages part:
# the port's LayerNorm backward sums the scaled row over E before it
# divides (PyTorch's kernel) and overflows at 2**126, where JAX's (the
# transpose of a mean: divide, then sum) does not. The finite steps are
# held at a scale of 2**8 that doubles after two of them.
FP16_OVERFLOW = {"fp16": {"enabled": True, "initial_scale_power": 127,
                          "hysteresis": 3}}
FP16_PREFETCH = {"fp16": {"enabled": True, "initial_scale_power": 8,
                          "loss_scale_window": 2}}


def _z3(prefetch=False, threshold=0, overlap_comm=True, bucket=100,
        offload=None, **kw):
    """``_cfg`` of the ZeRO stage tests at stage 3: ``stage3_prefetch``,
    the persistence threshold, and ``offload`` as the offload_optimizer."""
    cfg = _cfg(3, overlap_comm, bucket, **kw)
    zero = cfg["zero_optimization"]
    zero.update(stage3_prefetch=prefetch,
                stage3_param_persistence_threshold=threshold)
    if prefetch:
        zero["collective_matmul"] = {"min_shard_bytes": 0}
    if offload is not None:
        zero["offload_optimizer"] = offload
    return cfg


OFF = _z3()


def _cases(root):
    """The 2-rank cases: (name, the port's config, the JAX config, kind,
    model family). The NVMe runs take paths of their own, since both
    packages name their swap directories by the process id."""
    out = [("off_on_b100", OFF, None, "train", "gpt2"),
           ("off_off_default", _z3(overlap_comm=False, bucket=None), OFF,
            "train", "gpt2"),
           ("t300", _z3(threshold=300), None, "train", "gpt2"),
           ("gas2", _z3(gas=2), None, "train", "gpt2"),
           ("mixed", _z3(True, gas=2), None, "mixed", "gpt2"),
           ("loss_fn", _z3(True, overlap_comm=False, **FP16), None,
            "loss_fn", "gpt2"),
           ("llama", _z3(True), None, "train", "llama"),
           ("streamed", _z3(True, offload=STREAMED), None, "train", "gpt2"),
           ("host", _z3(offload=HOST), None, "train", "gpt2"),
           ("nvme", _z3(offload=_nvme(root / "port_nvme")),
            _z3(offload=_nvme(root / "jax_nvme")), "train", "gpt2"),
           ("fp16_prefetch", _z3(True, **FP16_PREFETCH), None, "train",
            "gpt2"),
           ("fp16_overflow", _z3(True, **FP16_OVERFLOW), None, "train",
            "gpt2")]
    return [(name, cfg, jcfg or cfg, kind, family)
            for name, cfg, jcfg, kind, family in out]


def _jax_llama_model():
    jnp = _jax()[1]
    jllama = importlib.import_module("deepspeed_tpu.models.llama")
    return jllama.LlamaForCausalLM(jllama.llama_tiny(dtype=jnp.float32,
                                                     scan_layers=True))


def _jax_llama_params():
    jax = _jax()[0]
    params = _jax_llama_model().init(
        jax.random.PRNGKey(0), np.zeros((1, SEQ), np.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _named(tree, family):
    """A JAX tree of ``family``'s model → {port name: numpy fp32}."""
    if family == "gpt2":
        return _by_name(tree)
    jax = _jax()[0]
    from deepspeed_tpu_torch.models import llama
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jax.device_get(tree))
    bridge = llama.LlamaForCausalLM(llama.llama_tiny(**LLAMA_KW))
    return {k: v.numpy() for k, v in bridge.from_jax_tree(tree).items()}


def _jax_run(n, cfg, params, batches, kind="train", family="gpt2",
             save_dir=None):
    """The JAX engine's run on n devices: {losses, masters, moments (by
    port name), loss scales, whether the prefetch path ran, the offload
    tier's class name, the next batch's loss after a save when
    ``save_dir``}."""
    jax, _, dstpu, _, jmesh = _jax()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=n),
                           devices=jax.devices()[:n])
    engine, _, _, _ = dstpu.initialize(
        config=cfg, model=_jax_model() if family == "gpt2"
        else _jax_llama_model(),
        model_parameters=jax.tree_util.tree_map(np.array, params),
        mesh=mesh, loss_fn=_jax_weighted_loss if kind == "loss_fn" else None)
    losses, scales = [], []
    for i, b in enumerate(batches[:STEPS]):
        if kind == "mixed" and 0 < i < STEPS - 1:
            gas = engine.gradient_accumulation_steps()
            rows = b["input_ids"].shape[0] // gas
            acc = 0.0
            for j in range(gas):
                loss = engine.forward({"input_ids": b["input_ids"][
                    j * rows:(j + 1) * rows]})
                engine.backward(loss)
                acc += float(loss) / gas
                engine.step()
            losses.append(acc)
        else:
            losses.append(float(engine.train_batch(b)))
        scales.append(float(engine.state.scaler["loss_scale"]))
    runner = engine._host_runner
    if runner is not None:
        sd = runner.state_dict()
        masters = _named(runner.params_tree(), family)
    else:
        sd = engine.state.opt_state
        masters = _named(engine.state.params, family)
    out = {"losses": losses, "masters": masters,
           "moments": {k: _named(sd[k], family)
                       for k in ("exp_avg", "exp_avg_sq")},
           "scales": scales, "prefetch": engine._prefetch_active(),
           "tier": None if runner is None else type(runner).__name__}
    if save_dir is not None:
        engine.save_checkpoint(save_dir, tag="t")
        out["next"] = float(engine.train_batch(batches[STEPS]))
    return out


def _jax_resume(n, cfg, ckpt_dir, params, nxt):
    jax, _, dstpu, _, jmesh = _jax()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=n),
                           devices=jax.devices()[:n])
    engine, _, _, _ = dstpu.initialize(
        config=cfg, model=_jax_model(),
        model_parameters=jax.tree_util.tree_map(np.array, params), mesh=mesh)
    engine.load_checkpoint(ckpt_dir)
    return float(engine.train_batch(nxt)), engine.global_steps


def _port_one_rank(cfg, ckpt_dir, nxt):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import gpt2
    engine, _, _, _ = ds.initialize(
        config=cfg, model=gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(**MODEL_KW)),
        device="cpu")
    engine.load_checkpoint(ckpt_dir)
    return float(engine.train_batch(nxt)), engine.global_steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank world in the background while JAX runs its data-4
    baseline and its data-2 save, then the 2-rank world (which resumes
    that save) in the background while JAX runs the 2-rank cases, then
    the resumes at one rank and in JAX."""
    from concurrent.futures import ThreadPoolExecutor
    root = tmp_path_factory.mktemp("zero3_gather")
    params = {"gpt2": _jax_params(), "llama": _jax_llama_params()}
    state = {f: _named(p, f) for f, p in params.items()}
    batches, weighted = _batches(), _batches(weights=True)
    nxt = batches[STEPS]
    dirs = {k: str(root / k) for k in ("jax2", "port2", "off2")}
    prefetch, streamed = _z3(True, bucket=None), _z3(offload=STREAMED)
    pool = ThreadPoolExecutor(1)
    four = pool.submit(spawn, worker.run_jobs, 4, [
        ("gather_cases", [("off", OFF, "train", "gpt2")], state,
         batches[:STEPS], MODEL_KWS)])
    jx = {(4, "off"): _jax_run(4, OFF, params["gpt2"], batches),
          (2, "off_on_b100"): _jax_run(2, OFF, params["gpt2"], batches,
                                       save_dir=dirs["jax2"])}
    four = four.result()
    cases = _cases(root)
    port = [(name, cfg, kind, fam) for name, cfg, _, kind, fam in cases]
    g2 = state["gpt2"]
    two = pool.submit(spawn, worker.run_jobs, 2, [
        ("gather_cases", [c for c in port if c[2] != "loss_fn"], state,
         batches[:STEPS], MODEL_KWS),
        ("gather_cases", [c for c in port if c[2] == "loss_fn"], state,
         weighted[:STEPS], MODEL_KWS),
        ("eval_logits", prefetch, g2, batches[0]["input_ids"], MODEL_KW),
        ("save_and_resume", OFF, g2, batches[:STEPS], nxt, dirs["port2"],
         MODEL_KW),
        ("resume", prefetch, g2, dirs["port2"], nxt, MODEL_KW),
        ("resume", OFF, g2, dirs["jax2"], nxt, MODEL_KW),
        ("save_and_resume", streamed, g2, batches[:STEPS], nxt,
         dirs["off2"], MODEL_KW),
        ("resume", OFF, g2, dirs["off2"], nxt, MODEL_KW),
        ("resume", streamed, g2, dirs["port2"], nxt, MODEL_KW)])
    for name, _, jcfg, kind, fam in cases:
        if (2, name) not in jx:
            jx[(2, name)] = _jax_run(
                2, jcfg, params[fam],
                weighted if kind == "loss_fn" else batches, kind, fam)
    jax_logits = np.asarray(_jax_model().apply(
        {"params": params["gpt2"]}, batches[0]["input_ids"]))
    two = two.result()
    pool.shutdown()
    return {"jax": jx, "four": four, "two": two, "state": state,
            "jax_logits": jax_logits,
            "jax_resumes_port2": _jax_resume(2, OFF, dirs["port2"],
                                             params["gpt2"], nxt),
            "one_rank": _port_one_rank(OFF, dirs["port2"], nxt)}


def _held(case, want, what):
    """Losses, masters and moments of a port case against a JAX run."""
    _close(case[0], want["losses"], f"{what} losses")
    _masters_close(case[1], want["masters"], what)
    _moments_close(case[2], want["moments"], what)


# -- the plan ----------------------------------------------------------------

def _jax_plan_cases():
    """(name, the JAX model, the port model (meta)) for the plan test."""
    jnp = _jax()[1]
    jgpt2 = importlib.import_module("deepspeed_tpu.models.gpt2")
    jllama = importlib.import_module("deepspeed_tpu.models.llama")
    from deepspeed_tpu_torch.models import gpt2, llama
    out = []
    for name, jc, tc in (
            ("gpt2_tiny", jgpt2.GPT2Config(
                vocab_size=512, n_positions=64, n_embd=64, n_layer=2,
                n_head=2, scan_layers=True),
             gpt2.gpt2_tiny(n_positions=64)),
            ("gpt2_large", jgpt2.gpt2_large(), gpt2.gpt2_large())):
        out.append((name, jgpt2.GPT2LMHeadModel(jc),
                    gpt2.GPT2LMHeadModel(tc)))
    for scan in (True, False):
        out.append((f"llama_tiny_scan{int(scan)}", jllama.LlamaForCausalLM(
            jllama.llama_tiny(dtype=jnp.float32, scan_layers=scan)),
            llama.LlamaForCausalLM(llama.llama_tiny(scan_layers=scan))))
    jbert = importlib.import_module("deepspeed_tpu.models.bert")
    from deepspeed_tpu_torch.models import bert
    out.append(("bert_tiny", jbert.BertForPreTraining(jbert.bert_tiny(
        dtype=jnp.float32, scan_layers=True)), bert.BertForPreTraining(
            bert.bert_tiny(scan_layers=True))))
    return out


@pytest.mark.parametrize("threshold", [0, 100000])
def test_stage3_plan_matches_jax_param_specs(threshold):
    """``stage3_param_plan`` of each port model against JAX's
    ZeroPartitioner.param_specs over the JAX model's own tree (stacked
    [L, ...] leaves under scan), at 2, 4 and 8 ranks: each port leaf's
    (dim, size) is its JAX leaf's spec with the layer dimension dropped.
    At GPT-2 large's default threshold the [36, 1280] leaves stay
    replicated and [36, 3840] is cut."""
    jax = _jax()[0]
    jpart = importlib.import_module("deepspeed_tpu.runtime.zero.partition")
    jmesh = importlib.import_module("deepspeed_tpu.parallel.mesh")
    P = jax.sharding.PartitionSpec
    for name, jmodel, model in _jax_plan_cases():
        tree = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), np.zeros((1, 8), np.int32)))["params"]
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        paths = model.jax_paths()
        for n in (2, 4, 8):
            mesh = jmesh.make_mesh(jmesh.MeshConfig(data=n),
                                   devices=jax.devices()[:n])
            jspecs = jpart.ZeroPartitioner(
                mesh, 3, param_persistence_threshold=threshold
            ).param_specs(tree)
            plan = tpart.stage3_param_plan(model, shapes, n, threshold)
            for (k, shape), entry in zip(shapes.items(), plan):
                path, layer = paths[k]
                spec = jspecs
                for key in path:
                    spec = spec[key]
                assert isinstance(spec, P)
                spec = tuple(spec) + (None,) * (len(shape) + (
                    layer is not None) - len(spec))
                if layer is not None:
                    assert spec[0] is None, (name, k)
                    spec = spec[1:]
                want = next(((d, shape[d] // n) for d, ax in enumerate(spec)
                             if ax == "data"), None)
                assert entry == want, (name, n, threshold, k)
        if name == "gpt2_large" and threshold:
            plan = dict(zip(shapes, tpart.stage3_param_plan(
                model, shapes, 4, threshold)))
            assert plan["h.0.ln_1.scale"] is None
            assert plan["h.0.attn.c_attn.bias"] == (0, 3840 // 4)
            assert plan["h.0.attn.c_attn.kernel"] == (1, 3840 // 4)
            assert plan["wte"] == (1, 1280 // 4)     # vocab 50257


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["off_on_b100", "off_off_default", "t300",
                                  "gas2", "mixed", "llama", "streamed",
                                  "host", "nvme"])
def test_two_rank_gather_path_matches_the_jax_engine_at_data_2(runs, name):
    """Every 2-rank case against the JAX engine on two devices: the
    losses, the masters and both moments; the path taken (gather, or the
    prefetch engine for "mixed") and JAX's; every rank reports the same
    losses; outside a step the module's parameters hold no storage."""
    two = runs["two"]
    case = two[0][0][name]
    want = runs["jax"][(2, name)]
    path = "prefetch" if name == "mixed" else "gather"
    assert case[4] == path and want["prefetch"] == (path == "prefetch")
    assert case[7], name
    assert case[6] == want["tier"]
    _held(case, want, name)
    for rank in two[1:]:
        np.testing.assert_array_equal(rank[0][name][0], case[0])


def test_four_rank_gather_path_matches_the_jax_engine_at_data_4(runs):
    four = runs["four"]
    _held(four[0][0]["off"], runs["jax"][(4, "off")], "4 ranks")
    for rank in four[1:]:
        assert rank[0]["off"][0] == four[0][0]["off"][0]


def test_overlap_and_bucket_do_not_change_the_gather_path(runs):
    """overlap_comm off at the default bucket (one bucket) trains bit for
    bit as overlap_comm on at 100 elements (a bucket a leaf)."""
    cases = runs["two"][0][0]
    a, b = cases["off_on_b100"], cases["off_off_default"]
    assert a[0] == b[0]
    assert all(np.array_equal(a[1][k], b[1][k]) for k in a[1])


def test_the_plan_shards_by_the_stacked_leaves(runs):
    """At threshold 300 a layer's c_attn bias (192 elements, 384 stacked)
    is cut and its LayerNorm scale (64, 128 stacked) kept whole; at 0
    every leaf of GPT-2 tiny is cut; at 4 ranks too."""
    from deepspeed_tpu_torch.models import gpt2
    names = [n for n, _ in gpt2.GPT2LMHeadModel(
        gpt2.gpt2_tiny(**MODEL_KW)).named_parameters()]
    t300 = dict(zip(names, runs["two"][0][0]["t300"][5]))
    assert t300["h.0.attn.c_attn.bias"] == (0, 96)
    assert t300["h.0.ln_1.scale"] is None and t300["ln_f.bias"] is None
    assert all(e is not None for e in runs["two"][0][0]["off_on_b100"][5])
    assert all(e is not None for e in runs["four"][0][0]["off"][5])


def test_fp16_user_loss_fn_overflow_skips_on_every_rank_as_jax(runs):
    """A user loss_fn with stage3_prefetch on falls back to the gather
    path (as JAX's does); under fp16 the second step's inf lies in the
    second rank's rows alone, yet every rank skips it and halves the
    scale; the trajectory, the masters and the moments as JAX's."""
    case = runs["two"][0][1]["loss_fn"]
    want = runs["jax"][(2, "loss_fn")]
    assert case[4] == "gather" and not want["prefetch"]
    assert np.isnan(case[0][1]) and np.isnan(want["losses"][1])
    assert case[3] == want["scales"] == [256.0, 128.0, 128.0]
    _held(case, want, "loss_fn")
    for rank in runs["two"][1:]:
        assert rank[1]["loss_fn"][3] == case[3]


def test_fp16_on_the_prefetch_path_follows_the_jax_scale(runs):
    """fp16 on the prefetch path (the finite flag all-reduced over the
    ranks): from 2**127 every step overflows on every rank, the first two
    keep the scale (hysteresis 3) and the third halves it, nothing is
    updated; from 2**8 every step is taken and the scale doubles after
    two. The scales, losses, masters and moments as JAX's prefetch
    path."""
    two = runs["two"]
    for name, scales in (("fp16_overflow", [2.0 ** 127, 2.0 ** 127,
                                            2.0 ** 126]),
                         ("fp16_prefetch", [256.0, 512.0, 512.0])):
        case, want = two[0][0][name], runs["jax"][(2, name)]
        assert case[4] == "prefetch" and want["prefetch"]
        assert case[3] == want["scales"] == scales, name
        _held(case, want, name)
        for rank in two[1:]:
            assert rank[0][name][3] == case[3]
    state = runs["state"]["gpt2"]
    _masters_close(two[0][0]["fp16_overflow"][1], state, "no update")


def test_offload_tiers_at_stage_3_hold_the_rank_shards(runs):
    """The three tiers build at stage 3 (the streamed one with
    stage3_prefetch on, which falls back); each rank's tier holds its
    shards; the NVMe ranks write directories of their own."""
    cases = runs["two"][0][0]
    assert cases["streamed"][6] == "StreamedOffloadOptimizer"
    assert cases["host"][6] == cases["nvme"][6] == "HostOffloadOptimizer"
    assert len(cases["nvme"][8]) == 2


def test_eval_batch_on_the_prefetch_path_returns_the_whole_batch(runs):
    want = runs["jax_logits"]
    for r, rank in enumerate(runs["two"]):
        logits = rank[2]
        assert logits.shape == want.shape
        _close(logits, want, f"eval rank {r}")


# -- checkpoints -------------------------------------------------------------

def test_gather_path_save_resumes_at_two_bit_for_bit(runs):
    for rank in runs["two"]:
        losses, want, got, files = rank[3]
        assert all(np.isfinite(losses))
        assert got == want
        assert "shard_index_1.json" in files


def test_gather_path_save_resumes_on_the_prefetch_path_one_rank_and_jax(
        runs):
    want = runs["two"][0][3][1]
    loss, steps, _ = runs["two"][0][4]
    _close(loss, want, "gather -> prefetch")
    assert steps == STEPS + 1
    for what, (loss, steps) in (("one rank", runs["one_rank"]),
                                ("jax", runs["jax_resumes_port2"])):
        _close(loss, want, f"gather -> {what}")
        assert steps == STEPS + 1


def test_a_jax_data2_stage3_save_resumes_on_the_gather_path(runs):
    want = runs["jax"][(2, "off_on_b100")]
    for rank in runs["two"]:
        loss, steps, _ = rank[5]
        _close(loss, want["next"], "jax 2 -> port 2")
        assert steps == STEPS + 1
    _masters_close(runs["two"][0][5][2], want["masters"], "jax 2 masters")


def test_offload_and_device_saves_resume_in_each_other_at_stage_3(runs):
    """A streamed-tier save resumed bit for bit by the streamed tier and,
    within rtol, by the device optimizer; a device save by the tier."""
    two = runs["two"][0]
    losses, want, got, _ = two[6]
    assert got == want
    _close(two[7][0], want, "offload -> device")
    _close(two[8][0], two[3][1], "device -> offload")


# -- what stays refused ------------------------------------------------------

def test_what_stage_3_does_not_run_at_world_n_raises_naming_roadmap():
    """MoQ at world n, a non-elementwise optimizer, the parameter tier at
    world n: refused at stage 3 on either path before any collective."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer
    from deepspeed_tpu_torch.parallel.mesh import Mesh
    moq = {"enabled": True, "quantize_bits": {"start_bits": 16,
                                              "target_bits": 8}}

    class Layerwise(TorchOptimizer):
        pass
    for prefetch in (False, True):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            ds.initialize(config=_z3(prefetch, quantize_training=moq),
                          model=gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny()),
                          mesh=Mesh(2, 0, "cpu"))
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            ds.initialize(config=_z3(prefetch), optimizer=Layerwise(),
                          model=gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny()),
                          mesh=Mesh(2, 0, "cpu"))
        cfg = _z3(prefetch)
        cfg["zero_optimization"]["offload_param"] = {"device": "cpu"}
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            DeepSpeedConfig(cfg, world_size=2)


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_gather_path_over_a_two_rank_heap_matches_plain(cuda_device):  # noqa: F811
    """Two ranks on the card train tiny GPT-2 on the gather path, and on
    the prefetch path through train_batch, forward/backward/step and
    eval_batch: one mm_rs_reduce launch a bucket a step of the bucket
    stream, the flash kernels a layer, and the losses, masters and eval
    logits against the same runs with mm_rs_reduce's plain version in the
    kernel's place, bit for bit. eval_batch gives every rank the whole
    batch's logits."""
    from deepspeed_tpu_torch.ops.cuda import builder
    builder.kernels()                 # build once before the ranks start
    for res in spawn(worker.heap_gather_path, 2):
        for path, (equal, launched, buckets, shape) in res.items():
            assert equal, path
            assert launched["mm_rs_reduce"] == buckets > 0, (path, launched)
            assert launched["flash_attention_fwd"] > 0, (path, launched)
        assert res["gather"][2] > 3
        assert res["prefetch"][3] == (8, 64, 512)
