"""deepspeed_tpu_torch's ZeRO-Offload tiers vs the JAX engine's, on the
CPU: fp16 with its unscale and its overflow skip, the ``cpuadam`` type,
forward / backward / step against train_batch, the streamed tier's unit
split against whole leaves, and checkpoints across the two packages
both ways. The tiers' trajectories, the parameter tiers and the refusals
are in tests/test_torch_offload.py, whose helpers this file takes.
"""

import numpy as np
import pytest
import torch

from test_torch_offload import (FP16_RTOL, LOSS_RTOL, _batches, _config,
                                _jax_engine, _jax_masters, _nvme, _params,
                                _port_engine, _port_masters, _run_both)
from torch_port_common import assert_close


def test_fp16_offload_matches_jax_and_skips_overflow():
    """fp16 with a loss scale of 256: both tiers unscale before the step
    (a 256x update would diverge at once) and track the JAX engine; an
    inf in the batch skips the step, keeps every master bit, and halves
    the scale."""
    for offload in ({"device": "cpu"}, {"device": "cpu", "stream": "host"}):
        cfg = _config(offload, fp16={"enabled": True,
                                     "initial_scale_power": 8,
                                     "hysteresis": 1})
        _, te = _run_both(cfg, rtol=FP16_RTOL)
        before = [m.clone() for m in te._host_runner.master_leaves()]
        count = te._host_runner.step_count
        scale = te.loss_scale
        bad = {"input_ids": _batches(1)[0]["input_ids"]}
        with torch.no_grad():
            te.compute_params[0].data[0, 0] = float("inf")
        te.train_batch(bad)
        assert te.loss_scale == scale / 2
        assert te._host_runner.step_count == count
        assert int(te.skipped_steps_t) == 1
        for a, b in zip(before, te._host_runner.master_leaves()):
            assert torch.equal(a, b)


def test_cpuadam_type_offloads_and_trains_without_offload():
    """``cpuadam`` builds DeepSpeedCPUAdam: with offload the host runner
    steps it as the JAX engine does; without, it runs as FusedAdam."""
    from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam
    opt = {"type": "CPUAdam", "params": {"lr": 3e-3, "weight_decay": 0.01}}
    _, te = _run_both(_config({"device": "cpu", "stream": "host"},
                              optimizer=opt))
    assert isinstance(te.optimizer, DeepSpeedCPUAdam)
    _run_both(_config(optimizer=opt), steps=3, rtol=2e-5)


@pytest.mark.parametrize("stream", ["auto", "host"])
def test_forward_backward_step_equals_train_batch(stream):
    """forward/backward/step on an offload engine take the offload update
    at the accumulation boundary: the same masters as train_batch."""
    cfg = _config({"device": "cpu", "stream": stream})
    e1, e2 = _port_engine(cfg, _params()), _port_engine(cfg, _params())
    for b in _batches(2):
        ids = b["input_ids"]
        e1.train_batch(b)
        for i in range(2):
            loss = e2.forward({"input_ids": ids[i * 2:(i + 1) * 2]})
            e2.backward(loss)
            e2.step()
    assert e1.global_steps == e2.global_steps == 2
    for a, b in zip(e1._host_runner.master_leaves(),
                    e2._host_runner.master_leaves()):
        assert_close(a, b)


def test_streamed_unit_split_matches_whole_leaves():
    """Leaves cut into row units of at most unit_bytes and packed into
    groups give the whole-leaf step bit for bit."""
    from deepspeed_tpu_torch.ops.adam import FusedAdam
    from deepspeed_tpu_torch.runtime.zero import offload_stream as os_
    rs = np.random.RandomState(0)
    shapes = [(37, 8), (5,), (64, 3), (1, 9)]
    masters = [torch.from_numpy(rs.randn(*s).astype(np.float32))
               for s in shapes]
    grads = [torch.from_numpy(rs.randn(*s).astype(np.float32))
             for s in shapes]
    opt = FusedAdam(lr=1e-2, weight_decay=0.1, moment_dtype="bf16")
    outs = []
    for unit_bytes in (1 << 20, 256):
        run = os_.StreamedOffloadOptimizer(masters, opt, "cpu",
                                           unit_bytes=unit_bytes)
        params = [m.clone() for m in masters]
        for _ in range(3):
            run.step([g.clone() for g in grads], params, torch.tensor(3e-3),
                     torch.tensor(0.5))
        outs.append((run, params))
    (whole, p0), (split, p1) = outs
    assert len(whole.units) == 4 and len(whole.groups) == 1
    assert len(split.units) > 4 and len(split.groups) > 1
    assert [u.split for u in split.units[:4]] == [True] * 4
    for a, b in zip(p0 + whole.master_leaves(), p1 + split.master_leaves()):
        assert torch.equal(a, b)
    sd0, sd1 = whole.state_dict(), split.state_dict()
    for k in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(sd0[k], sd1[k]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("tier", ["streamed", "host"])
def test_jax_offload_checkpoint_resumes_in_the_port(tier, tmp_path):
    """A JAX offload engine's checkpoint (fp32 masters, moments, step
    count) resumes in the port's offload engine and continues the JAX
    trajectory."""
    offload = {"device": "cpu"} if tier == "streamed" \
        else {"device": "cpu", "stream": "host"}
    cfg, params = _config(offload), _params()
    je = _jax_engine(cfg, params)
    for b in _batches(3):
        je.train_batch(b)
    je.save_checkpoint(str(tmp_path), tag="t3")
    te = _port_engine(cfg, _params())
    te.load_checkpoint(str(tmp_path), tag="t3")
    assert te._host_runner.step_count == 3 and te.global_steps == 3
    for b in _batches(2, first=3):
        assert float(te.train_batch(b)) == pytest.approx(
            float(je.train_batch(b)), rel=LOSS_RTOL)
    want = _jax_masters(te, je)
    for name, m in _port_masters(te).items():
        assert_close(m, want[name], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("tier", ["streamed", "nvme"])
def test_port_offload_checkpoint_loads_in_the_jax_engine(tier, tmp_path):
    """The port's offload checkpoint is the JAX format: the JAX offload
    engine loads it and both continue the same trajectory; the port's
    own engine restores it too."""
    cfg = _config({"device": "cpu"}) if tier == "streamed" \
        else _config(_nvme(tmp_path / "port"))
    # the JAX engine loads into its streamed tier: its NVMe runner, rebuilt
    # at load, loses its pid-named swap directory to the finalizer of the
    # runner it replaces (ROADMAP §3)
    cfg_j = _config({"device": "cpu"})
    te = _port_engine(cfg, _params())
    for b in _batches(3):
        te.train_batch(b)
    te.save_checkpoint(str(tmp_path / "ckpt"), tag="t3")
    je = _jax_engine(cfg_j, _params())
    je.load_checkpoint(str(tmp_path / "ckpt"), tag="t3")
    for b in _batches(2, first=3):
        lj = float(je.train_batch(b))
        assert float(te.train_batch(b)) == pytest.approx(lj, rel=LOSS_RTOL)
    want = _jax_masters(te, je)
    for name, m in _port_masters(te).items():
        assert_close(m, want[name], atol=2e-5, rtol=2e-5)


def test_port_checkpoint_restores_the_port_engine_exactly(tmp_path):
    cfg = _config({"device": "cpu"})
    te = _port_engine(cfg, _params())
    for b in _batches(3):
        te.train_batch(b)
    te.save_checkpoint(str(tmp_path), tag="t3")
    te2 = _port_engine(cfg, _params())
    te2.load_checkpoint(str(tmp_path), tag="t3")
    for b in _batches(2, first=3):
        assert float(te2.train_batch(b)) == float(te.train_batch(b))
    for a, b in zip(te._host_runner.master_leaves(),
                    te2._host_runner.master_leaves()):
        assert torch.equal(a, b)
