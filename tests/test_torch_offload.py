"""deepspeed_tpu_torch's ZeRO-Offload tiers vs the JAX engine's, on the CPU.

The same GPT-2 tiny weights (the JAX model's init, carried across by the
port's bridge) and the same seeded batches go through ``initialize`` +
``train_batch`` of both packages with the same config, at each tier: the
streamed tier (state in host memory, the update on the device), the host
runner (``stream: "host"``, the native SIMD step), NVMe moments (plain
and write-behind), the NVMe parameter tier (with an offload tier, and
with the device optimizer), the pinned parameter tier (``offload_param``
cpu, with and without an offload tier) and ``overlap_comm`` with gas 4;
5 steps each, held at the JAX package's own tolerances
(tests/test_offload.py); and the refusals that stay. fp16, the
``cpuadam`` type, forward / backward / step, the streamed tier's unit
split and the checkpoints are in tests/test_torch_offload_checkpoints.py,
which shares this file's helpers.
"""

import glob

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
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
from deepspeed_tpu_torch.runtime.zero.offload_stream import \
    StreamedOffloadOptimizer
from torch_port_common import assert_close

VOCAB, SEQ = 512, 16
# JAX's own bounds: offload against the device optimizer and across tiers
# (tests/test_offload.py:175-190, :471-530)
LOSS_RTOL, OVERLAP_RTOL, FP16_RTOL = 1e-3, 2e-3, 2e-2


def _np32(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _params():
    model = jgpt2.GPT2LMHeadModel(jgpt2.gpt2_tiny(dtype=jnp.float32))
    return model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, SEQ), jnp.int32))["params"]


def _one_device_mesh():
    from deepspeed_tpu.parallel.mesh import MeshConfig, make_mesh
    return make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])


def _config(offload=None, param=None, **over):
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "steps_per_print": 100, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"total_num_steps": 10,
                                    "warmup_num_steps": 2,
                                    "warmup_max_lr": 3e-3,
                                    "warmup_type": "linear"}},
           "zero_optimization": {"stage": 2}}
    if offload is not None:
        cfg["zero_optimization"]["offload_optimizer"] = offload
    if param is not None:
        cfg["zero_optimization"]["offload_param"] = param
    cfg.update(over)
    return cfg


def _jax_engine(cfg, params):
    model = jgpt2.GPT2LMHeadModel(jgpt2.gpt2_tiny(dtype=jnp.float32))
    engine, _, _, _ = dstpu.initialize(config=cfg, model=model,
                                       model_parameters=params,
                                       mesh=_one_device_mesh())
    return engine


def _port_engine(cfg, params):
    model = tgpt2.GPT2LMHeadModel(tgpt2.gpt2_tiny(dtype=torch.float32))
    sd = model.from_jax_tree(_np32(params))
    engine, _, _, _ = dst.initialize(config=cfg, model=model,
                                     model_parameters=sd, device="cpu")
    return engine


def _batches(n, batch=4, first=0):
    return [{"input_ids": np.random.RandomState(first + i).randint(
        0, VOCAB, size=(batch, SEQ)).astype(np.int32)} for i in range(n)]


def _port_masters(te):
    return dict(zip(te.param_names, te._host_runner.master_leaves()))


def _jax_masters(te, je):
    return te.module.from_jax_tree(_np32(je._host_runner.params_tree()))


def _run_both(cfg, steps=5, batch=4, rtol=LOSS_RTOL, port_cfg=None):
    """Both engines over ``steps`` batches, the losses held at ``rtol``;
    ``port_cfg`` (default ``cfg``) gives the port its own swap paths (both
    packages name their swap directories by the process id)."""
    params = _params()
    je = _jax_engine(cfg, params)
    te = _port_engine(port_cfg or cfg, params)
    for b in _batches(steps, batch):
        lj = float(je.train_batch(b))
        lt = float(te.train_batch(b))
        assert lt == pytest.approx(lj, rel=rtol)
    assert te.global_steps == je.global_steps == steps
    return je, te


def _nvme(path, **kw):
    path.mkdir(exist_ok=True)
    return dict({"device": "nvme", "nvme_path": str(path)}, **kw)


def _both(make, tmp_path):
    """(JAX config, port config) from ``make(path)``, on two paths."""
    return make(tmp_path / "jax"), make(tmp_path / "port")


@pytest.mark.parametrize("tier", ["streamed", "host", "nvme",
                                  "nvme_pipeline_write"])
def test_offload_tier_trajectory_matches_jax_engine(tier, tmp_path):
    """5 steps of AdamW with gas 2, clipping and WarmupDecayLR on each
    optimizer tier: losses at JAX's offload bound, the fp32 masters at
    fp32 2e-5 (both sides run the same arithmetic on the same gradients),
    the right runner and no optimizer state on the device."""
    make = {"streamed": lambda p: _config({"device": "cpu"}),
            "host": lambda p: _config({"device": "cpu", "stream": "host"}),
            "nvme": lambda p: _config(_nvme(p)),
            "nvme_pipeline_write": lambda p: _config(_nvme(
                p, pipeline_write=True, buffer_count=2))}[tier]
    cfg_j, cfg_t = _both(make, tmp_path)
    je, te = _run_both(cfg_j, port_cfg=cfg_t)
    want_cls = StreamedOffloadOptimizer if tier == "streamed" \
        else HostOffloadOptimizer
    assert isinstance(te._host_runner, want_cls)
    assert te.opt_state == {} and te.master is None
    want = _jax_masters(te, je)
    for name, m in _port_masters(te).items():
        assert_close(m, want[name], atol=2e-5, rtol=2e-5)
    if tier.startswith("nvme"):
        files = glob.glob(str(tmp_path) + "/port/optimizer_swap_*/*.swp")
        assert len(files) == 2 * len(te.param_names)
        assert te.take_swap_stall_s() >= 0.0
    te.close()


@pytest.mark.parametrize("optimizer_tier", ["streamed", "host_push",
                                            "host_write_behind"])
def test_nvme_parameter_tier_matches_jax_engine(optimizer_tier, tmp_path):
    """offload_param nvme: the parameters rest in swap files between steps
    (the module holds no parameter storage), stream back before the next
    forward, and the trajectory is JAX's. The host runner with
    pipeline_write parks the SIMD step's output straight to the
    write-behind queue."""
    make = {
        "streamed": lambda p: _config({"device": "cpu"}, _nvme(p)),
        "host_push": lambda p: _config({"device": "cpu", "stream": "host"},
                                       _nvme(p)),
        "host_write_behind": lambda p: _config(
            {"device": "cpu", "stream": "host"},
            _nvme(p, pipeline_write=True, pipeline_read=True,
                  buffer_count=3)),
    }[optimizer_tier]
    cfg_j, cfg_t = _both(make, tmp_path)
    je, te = _run_both(cfg_j, port_cfg=cfg_t)
    assert te._params_parked
    assert all(p.numel() == 0 for p in te.module.parameters())
    files = glob.glob(str(tmp_path) + "/port/param_swap_*/*.swp")
    assert len(files) == len(te.param_names)
    logits = te.eval_batch(_batches(1)[0])          # unparks
    assert not te._params_parked and torch.isfinite(logits).all()
    te.close()


def _jax_param_masters(te, je):
    je._ensure_params_resident()          # a parked JAX engine's too
    return te.module.from_jax_tree(_np32(jax.device_get(je.state.params)))


@pytest.mark.parametrize("param, offload", [
    ({"device": "cpu"}, None), ("legacy", None),
    ({"device": "cpu"}, {"device": "cpu"}), ("legacy", {"device": "cpu"}),
    ({"device": "cpu"}, "nvme")])
def test_cpu_parameter_tier_matches_jax_engine(param, offload, tmp_path):
    """offload_param cpu (or the legacy cpu_offload_params): between steps
    the parameters rest in the host arena, the module holds no parameter
    storage (nor the engine its masters, with the device optimizer), and
    they come back before the next forward. JAX's engine makes the tier a
    no-op off a TPU, so the parked run must give its trajectory: at fp32
    2e-5 with the device optimizer, at JAX's offload bound with an
    offload tier (streamed, or NVMe moments)."""
    def make(path):
        cfg = _config(_nvme(path) if offload == "nvme" else offload,
                      None if param == "legacy" else param)
        if param == "legacy":
            cfg["zero_optimization"]["cpu_offload_params"] = True
        return cfg
    cfg_j, cfg_t = _both(make, tmp_path)
    je, te = _run_both(cfg_j, port_cfg=cfg_t,
                       rtol=2e-5 if offload is None else LOSS_RTOL)
    assert te._params_parked and te._param_host.nbytes > 0
    assert all(p.numel() == 0 for p in te.module.parameters())
    if offload is None:
        assert te.master is None
        want = _jax_param_masters(te, je)
        masters = te.gather_master()          # unparks
    else:
        want = _jax_masters(te, je)
        masters = _port_masters(te)
    for name, m in masters.items():
        assert_close(m, want[name], atol=2e-5, rtol=2e-5)
    logits = te.eval_batch(_batches(1)[0])
    assert not te._params_parked and torch.isfinite(logits).all()
    te.close()


def test_nvme_parameter_tier_with_the_device_optimizer(tmp_path):
    """offload_param nvme without offload_optimizer: the device optimizer
    keeps its moments on the device, and its fp32 masters rest in the
    swap files between steps (JAX parks its fp32 params). The trajectory
    is JAX's at fp32 2e-5; a checkpoint saved while parked loads in the
    other package, and both continue on one trajectory."""
    cfg_j, cfg_t = _both(lambda p: _config(param=_nvme(p)), tmp_path)
    je, te = _run_both(cfg_j, port_cfg=cfg_t, rtol=2e-5)
    assert te._params_parked and te.master is None
    assert te.opt_state["exp_avg"][0].numel() > 0
    sw = te._param_swapper
    assert [sw.meta[i][1] for i in sw.meta] == [torch.float32] * len(
        te.param_names)
    want = _jax_param_masters(te, je)
    for name, m in te.gather_master().items():
        assert_close(m, want[name], atol=2e-5, rtol=2e-5)
    te.train_batch(_batches(1, first=5)[0])          # parked again
    je.train_batch(_batches(1, first=5)[0])
    assert te._params_parked
    te.save_checkpoint(str(tmp_path / "ckpt_t"), tag="t6")
    je.save_checkpoint(str(tmp_path / "ckpt_j"), tag="t6")
    jb = _jax_engine(_config(param=_nvme(tmp_path / "jb")), _params())
    jb.load_checkpoint(str(tmp_path / "ckpt_t"), tag="t6")
    tb = _port_engine(_config(param=_nvme(tmp_path / "tb")), _params())
    tb.load_checkpoint(str(tmp_path / "ckpt_j"), tag="t6")
    for b in _batches(2, first=6):
        want = float(je.train_batch(b))
        for e in (te, jb, tb):
            assert float(e.train_batch(b)) == pytest.approx(want, rel=2e-5)
    assert tb._params_parked
    te.close()
    tb.close()


def test_overlap_comm_gas4_matches_jax_engine():
    """overlap_comm with gas 4 on the host runner: each micro batch's
    gradients fold into fp32 host accumulators while the next computes;
    the trajectory is the JAX engine's on the same path."""
    cfg = _config({"device": "cpu", "stream": "host"},
                  train_batch_size=8, gradient_accumulation_steps=4)
    cfg["zero_optimization"]["overlap_comm"] = True
    _run_both(cfg, batch=8, rtol=OVERLAP_RTOL)


def _infinity_config(**over):
    cfg = _config(**over)
    cfg["zero_optimization"] = {
        "stage": 3, "offload_optimizer": {"device": "cpu"},
        "offload_param": {"device": "cpu", "stream_segments": 2}}
    return cfg


def _llama_model():
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
    return LlamaForCausalLM(llama_tiny())


@pytest.mark.parametrize("build, error, match", [
    # offload_param at world size > 1 (the ZeRO stages over ranks)
    (lambda: DeepSpeedConfig({"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu"}}}, world_size=2),
     NotImplementedError, "ZeRO stages over torch.distributed"),
    # MoQ with the parameter tier
    (lambda: _port_engine(_config(param={"device": "cpu"},
                                  quantize_training={"enabled": True}),
                          _params()),
     NotImplementedError, "ZeRO-Offload / Infinity"),
    # what JAX's InfinityEngine would silently ignore
    (lambda: _port_engine(_infinity_config(), _params()),
     NotImplementedError, "gradient_clipping with offload_param"),
    # the Infinity engine streams GPT-2 alone
    (lambda: dst.initialize(config=_infinity_config(gradient_clipping=0.0,
                                                    scheduler=None),
                            model=_llama_model(), device="cpu"),
     ValueError, "streams GPT-2"),
    # the parameter tier with stage3_prefetch at world size > 1 (the
    # optimizer tiers with stage3_prefetch build, and fall back)
    (lambda: DeepSpeedConfig({"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "stage3_prefetch": True,
        "offload_param": {"device": "cpu"}}}, world_size=4),
     NotImplementedError, "ZeRO stages over torch.distributed"),
])
def test_refusals_that_stay_name_roadmap(build, error, match):
    """What still raises around the offload tiers: the parameter tier at
    world size > 1 (ROADMAP item 4; the optimizer tiers run at world size
    n at every stage), MoQ with them (item 3), and the Infinity engine
    given what JAX's ignores or a model it does not stream."""
    with pytest.raises(error, match=match):
        if callable(build):
            build()
        else:
            DeepSpeedConfig({"train_batch_size": 8, "zero_optimization":
                             dict({"stage": 2}, **build)})


def test_offload_refusals_at_world_size_and_with_moq():
    """The parameter tier at world size 2 raises; the optimizer tier at
    stage 3 there builds (with stage3_prefetch too, at any world size:
    the engine falls back, as JAX's does); MoQ with a tier raises."""
    cfg = {"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu"}}}
    with pytest.raises(NotImplementedError, match="ZeRO stages over"):
        DeepSpeedConfig(cfg, world_size=2)
    for world in (1, 2):
        zc = DeepSpeedConfig({"train_batch_size": 8, "zero_optimization": {
            "stage": 3, "stage3_prefetch": True,
            "offload_optimizer": {"device": "cpu"}}},
            world_size=world).zero_config
        assert zc.offload_optimizer.enabled and zc.stage3_prefetch
    cfg = _config({"device": "cpu"}, quantize_training={"enabled": True})
    with pytest.raises(NotImplementedError, match="ZeRO-Offload / Infinity"):
        _port_engine(cfg, _params())


@pytest.mark.parametrize("zero, match", [
    ({"offload_optimizer": {"device": "nvme"}},
     "offload_optimizer device=nvme requires nvme_path"),
    ({"offload_param": {"device": "nvme"},
      "offload_optimizer": {"device": "cpu"}},
     "offload_param device=nvme requires nvme_path"),
    ({"offload_optimizer": {"device": "nvme", "nvme_path": "/x",
                            "stream": "device"}},
     "stream='device' supports device='cpu'"),
    ({"offload_optimizer": {"device": "cpu", "stream": "sideways"}},
     "offload stream must be auto|device|host"),
    ({"offload_optimizer": {"device": "cpu", "stream_segments": 2}},
     "'stream_segments' applies to offload_param only"),
    ({"offload_optimizer": {"device": "cpu", "buffer_count": 0}},
     "buffer_count must be >= 1"),
])
def test_offload_config_errors_carry_the_jax_messages(zero, match):
    cfg = {"train_batch_size": 8, "zero_optimization": dict(
        {"stage": 2}, **zero)}
    with pytest.raises(ValueError, match=match):
        DeepSpeedConfig(cfg)


def test_aio_config_matches_jax():
    from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig
    for aio in ({}, {"block_size": 8192, "queue_depth": 4,
                     "thread_count": 3, "o_direct": True}):
        cfg = {"train_batch_size": 8, "aio": aio}
        j, t = JConfig(cfg).aio_config, DeepSpeedConfig(cfg).aio_config
        for key in ("block_size", "queue_depth", "thread_count",
                    "single_submit", "overlap_events", "o_direct"):
            assert getattr(t, key) == getattr(j, key), key
    for bad in ({"o_direct": 1}, {"block_size": 0},
                {"o_direct": True, "block_size": 1000}):
        with pytest.raises(ValueError) as want:
            JConfig({"train_batch_size": 8, "aio": bad})
        with pytest.raises(ValueError) as got:
            DeepSpeedConfig({"train_batch_size": 8, "aio": bad})
        assert str(got.value) == str(want.value)
