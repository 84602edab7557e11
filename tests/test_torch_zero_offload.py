"""deepspeed_tpu_torch's ZeRO-Offload at world size n vs the JAX package,
on the CPU.

Tiny GPT-2 trained by ``initialize(mesh=...)`` in gloo worlds of 2 and 4
processes with ``offload_optimizer``, against the JAX engine on
``MeshConfig(data=n)`` with the same offload block, on the same weights
and batches: three steps' losses, the updated fp32 masters and both Adam
moments at rtol 2e-5 (each moment leaf also at 2e-5 of its largest
value, as they reach 1e-9). At 2 ranks the streamed tier (state in host
memory, the update on the device) at stages 0, 1 and 2, the host runner
(``stream: "host"``, the native SIMD step) and NVMe moments (the two
ranks sharing one ``nvme_path``), gas 2, forward / backward / step, a
gradient clip that bites, and fp16 with a user loss_fn whose overflow
lies in one rank's rows (every rank skips, the loss scale halves as
JAX's); at 4 ranks the streamed tier at stage 2. Then the per-rank
checkpoints: a 2-rank offload save resumed at 2 (bit for bit), at 1 rank,
by the JAX engine's streamed tier at data 2 and by the device optimizer
at 2; a device-optimizer save resumed by the offload tier; a JAX data-2
offload save resumed by the port at 2 ranks and at 1. The one gpu test
holds the streamed tier on strided slices against FusedAdam on the same
slices on the card, bit for bit. JAX is imported inside the tests, so
the gpu test runs where it is not installed.
"""

import os

import numpy as np
import pytest
import torch

import torch_zero_offload_worker as worker
from deepspeed_tpu_torch.parallel.mesh import spawn
from test_torch_zero_stages import (FP16, MODEL_KW, RTOL, STEPS, _batches,
                                    _by_name, _cfg, _close, _jax_engine,
                                    _jax_params, _jax_weighted_loss,
                                    _masters_close)
from torch_port_common import cuda_device  # noqa: F401

STREAMED = {"device": "cpu"}
HOST = {"device": "cpu", "stream": "host"}
CLIP = 0.05          # under every step's gradient norm of the tiny model


def _nvme(path):
    os.makedirs(path, exist_ok=True)
    return {"device": "nvme", "nvme_path": str(path)}


def _off(stage, offload, **kw):
    """``_cfg`` of the ZeRO stage tests (bucket 100: several buckets)
    with ``offload`` as its ``offload_optimizer``."""
    cfg = _cfg(stage, **kw)
    cfg["zero_optimization"]["offload_optimizer"] = offload
    return cfg


def _cases(root):
    """The 2-rank cases: (name, the port's config, the JAX config, kind);
    the two packages' NVMe runs take paths of their own, since both name
    their swap directories by the process id."""
    fp16 = _off(2, STREAMED, overlap_comm=False, **FP16)
    out = [(f"s{s}", _off(s, STREAMED), None, "train") for s in (0, 1, 2)]
    out += [("host", _off(2, HOST), None, "train"),
            ("nvme", _off(2, _nvme(root / "port_nvme")),
             _off(2, _nvme(root / "jax_nvme")), "train"),
            ("gas2", _off(2, STREAMED, gas=2), None, "train"),
            ("fwd_bwd_step", _off(2, HOST, gas=2), None, "fwd_bwd_step"),
            ("clip", _off(2, STREAMED, gradient_clipping=CLIP), None,
             "train"),
            ("fp16", fp16, None, "loss_fn")]
    return [(name, cfg, jcfg or cfg, kind) for name, cfg, jcfg, kind in out]


def _jax_offload(n, cfg, params, batches, loss_fn=None, save_dir=None):
    """The JAX engine's offload run: (losses, masters by port name,
    {exp_avg, exp_avg_sq} by port name, loss scales, the tier's class
    name, the next batch's loss after a save when ``save_dir``)."""
    engine = _jax_engine(n, cfg, params, loss_fn)
    losses, scales = [], []
    for b in batches[:STEPS]:
        losses.append(float(engine.train_batch(b)))
        scales.append(float(engine.state.scaler["loss_scale"]))
    runner = engine._host_runner
    sd = runner.state_dict()
    out = [losses, _by_name(runner.params_tree()),
           {k: _by_name(sd[k]) for k in ("exp_avg", "exp_avg_sq")},
           scales, type(runner).__name__, None]
    if save_dir is not None:
        engine.save_checkpoint(save_dir, tag="t")
        out[5] = float(engine.train_batch(batches[STEPS]))
    return out


def _jax_resume(n, cfg, ckpt_dir, params, nxt):
    engine = _jax_engine(n, cfg, params)
    engine.load_checkpoint(ckpt_dir)
    return float(engine.train_batch(nxt)), engine.global_steps


def _port_resume_one_rank(cfg, ckpt_dir, nxt):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import gpt2
    engine, _, _, _ = ds.initialize(
        config=cfg, model=gpt2.GPT2LMHeadModel(gpt2.gpt2_tiny(**MODEL_KW)),
        device="cpu")
    engine.load_checkpoint(ckpt_dir)
    loss = float(engine.train_batch(nxt))
    steps = engine.global_steps
    engine.close()
    return loss, steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank world in the background while JAX runs its data-4
    baseline and its data-2 save, then the 2-rank world (which resumes
    that save) in the background while JAX runs the 2-rank baselines,
    then the resumes at one rank and in JAX."""
    from concurrent.futures import ThreadPoolExecutor
    root = tmp_path_factory.mktemp("zero_offload")
    params = _jax_params()
    state = _by_name(params)
    batches, weighted = _batches(), _batches(weights=True)
    nxt = batches[STEPS]
    dirs = {k: str(root / k) for k in ("jax2", "port2", "dev2")}
    s2 = _off(2, STREAMED)
    pool = ThreadPoolExecutor(1)
    four = pool.submit(spawn, worker.run_jobs, 4, [
        ("offload_cases", [("s2", s2, "train")], state, batches[:STEPS],
         MODEL_KW)])
    jx = {(4, "s2"): _jax_offload(4, s2, params, batches),
          (2, "s2"): _jax_offload(2, s2, params, batches,
                                  save_dir=dirs["jax2"])}
    four = four.result()
    cases = _cases(root)
    port = [(name, cfg, kind) for name, cfg, _, kind in cases]
    two = pool.submit(spawn, worker.run_jobs, 2, [
        ("offload_cases", port[:-1], state, batches[:STEPS], MODEL_KW),
        ("offload_cases", port[-1:], state, weighted[:STEPS], MODEL_KW),
        ("save_and_resume", s2, state, batches[:STEPS], nxt, dirs["port2"],
         MODEL_KW),
        ("resume", _cfg(2), state, dirs["port2"], nxt, MODEL_KW),
        ("save_and_resume", _cfg(2), state, batches[:STEPS], nxt,
         dirs["dev2"], MODEL_KW),
        ("resume", s2, state, dirs["dev2"], nxt, MODEL_KW),
        ("resume", s2, state, dirs["jax2"], nxt, MODEL_KW)])
    for name, _, jcfg, kind in cases:
        if (2, name) not in jx:
            jx[(2, name)] = _jax_offload(
                2, jcfg, params, weighted if kind == "loss_fn" else batches,
                loss_fn=_jax_weighted_loss if kind == "loss_fn" else None)
    two = two.result()
    pool.shutdown()
    return {"jax": jx, "four": four, "two": two, "batches": batches,
            "jax_resumes_port2": _jax_resume(2, s2, dirs["port2"], params,
                                             nxt),
            "one_rank": {k: _port_resume_one_rank(s2, dirs[k], nxt)
                         for k in ("port2", "jax2")}}


def _moments_close(got, want, what):
    """Each moment leaf at rtol 2e-5 and at 2e-5 of its largest value."""
    for k in ("exp_avg", "exp_avg_sq"):
        assert set(got[k]) == set(want[k]), what
        for name, w in want[k].items():
            np.testing.assert_allclose(
                got[k][name], w, rtol=RTOL,
                atol=RTOL * float(np.abs(w).max()),
                err_msg=f"{what} {k} {name}")


def _held(case, want, what):
    """Losses, masters and moments of a port case against a JAX run."""
    _close(case[0], want[0], f"{what} losses")
    _masters_close(case[1], want[1], what)
    _moments_close(case[2], want[2], what)


def _fp16_held(case, want):
    """fp16: the compute copy and the gradients are fp16 in both
    packages, but each rank rounds its own gradients to fp16 before the
    exchange (the reference's shape) where JAX rounds the sum GSPMD made
    in fp32: a gradient may differ by an fp16 unit. So the losses at
    rtol 2e-5; the masters at rtol 2e-5 on all but 0.01 % of elements,
    each of those within one Adam step (lr 1e-3); the moments at rtol
    2e-5 and 2**-10 (an fp16 unit) of each leaf's largest value."""
    _close(case[0], want[0], "fp16 losses")
    off = total = 0
    for name, w in want[1].items():
        d = np.abs(case[1][name] - w)
        assert d.max() <= 1e-3, name
        off += int((d > 1e-5 + RTOL * np.abs(w)).sum())
        total += w.size
    assert off <= 1e-4 * total, (off, total)
    for k in ("exp_avg", "exp_avg_sq"):
        for name, w in want[2][k].items():
            np.testing.assert_allclose(
                case[2][k][name], w, rtol=RTOL,
                atol=2.0 ** -10 * float(np.abs(w).max()),
                err_msg=f"fp16 {k} {name}")


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["s0", "s1", "s2", "host", "nvme", "gas2",
                                  "fwd_bwd_step", "clip", "fp16"])
def test_two_rank_offload_matches_the_jax_engine_at_data_2(runs, name):
    """Every 2-rank case against the JAX engine with the same offload
    block on two devices, the same tier on both sides; every rank reports
    the same losses."""
    two = runs["two"]
    case = two[0][0][name] if name != "fp16" else two[0][1][name]
    want = runs["jax"][(2, name)]
    tier = {"host": "HostOffloadOptimizer", "nvme": "HostOffloadOptimizer",
            "fwd_bwd_step": "HostOffloadOptimizer"}.get(
                name, "StreamedOffloadOptimizer")
    assert case[4] == want[4] == tier
    if name == "fp16":
        _fp16_held(case, want)
    else:
        _held(case, want, name)
    for rank in two[1:]:
        got = rank[0][name] if name != "fp16" else rank[1][name]
        np.testing.assert_array_equal(got[0], case[0])


def test_four_rank_streamed_tier_matches_the_jax_engine_at_data_4(runs):
    four = runs["four"]
    _held(four[0][0]["s2"], runs["jax"][(4, "s2")], "4 ranks")
    for rank in four[1:]:
        assert rank[0]["s2"][0] == four[0][0]["s2"][0]


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_keeps_its_slices_on_the_host(runs, n):
    """Stage 0 keeps every leaf whole on every rank; stages 1 and 2 give
    each rank its slice of every leaf (a dim of which n divides): the
    tier's leaves are the slices, and their elements over the ranks sum
    to the model's."""
    world = runs["two"] if n == 2 else runs["four"]
    name = "s2"
    full = {k: v.shape for k, v in world[0][0][name][1].items()}
    total = sum(int(np.prod(s)) for s in full.values())
    shapes = [rank[0][name][5] for rank in world]
    assert all(sum(int(np.prod(s)) for s in sh) == total // n
               for sh in shapes)
    assert sorted(map(tuple, shapes[0])) != sorted(full.values())
    if n == 2:
        s0 = [rank[0]["s0"][5] for rank in world]
        assert s0[0] == s0[1]
        assert sorted(s0[0]) == sorted(tuple(s) for s in full.values())
        assert world[0][0]["s1"][5] == shapes[0]


def test_nvme_ranks_share_one_path_in_directories_of_their_own(runs):
    """The two ranks' swap directories lie side by side under the one
    nvme_path, each named by its process, and each holds its rank's
    moment slices alone (two fp32 files a leaf of the slice's bytes)."""
    per_rank = [rank[0]["nvme"] for rank in runs["two"]]
    dirs = per_rank[0][7]
    assert len(dirs) == 2 and dirs == per_rank[1][7]
    assert len({d.rsplit("_", 1)[-1] for d in dirs}) == 2
    for r in per_rank:
        sizes, shapes = r[6], r[5]
        assert sorted(sizes.values()) == sorted(
            4 * int(np.prod(s)) for s in shapes for _ in range(2))


def test_the_clip_bites(runs):
    """The clip case's norms lie over the clip, so its coefficient
    scales the step (a clip under the norm would test nothing)."""
    case = runs["two"][0][0]["clip"]
    assert case[8] > 2 * CLIP
    assert not np.allclose(case[1]["wte"], runs["two"][0][0]["s2"][1]["wte"])


def test_fp16_overflow_on_one_rank_skips_on_every_rank_as_jax(runs):
    """The second step's inf lies in the second rank's rows alone: every
    rank skips the step and halves the scale, as JAX's offload engine."""
    want = runs["jax"][(2, "fp16")]
    for rank in runs["two"]:
        case = rank[1]["fp16"]
        assert np.isnan(case[0][1]) and np.isnan(want[0][1])
        assert case[3] == want[3] == [256.0, 128.0, 128.0]


# -- checkpoints -------------------------------------------------------------

def test_two_rank_offload_save_resumes_at_two_bit_for_bit(runs):
    for rank in runs["two"]:
        losses, want, got, files = rank[2]
        assert all(np.isfinite(losses))
        assert got == want
        assert "shard_index_1.json" in files


def test_offload_and_device_optimizer_saves_resume_in_each_other(runs):
    """An offload save resumed by the device optimizer at 2 ranks, and a
    device-optimizer save by the offload tier: the uninterrupted run's
    next loss."""
    two = runs["two"][0]
    want_off, want_dev = two[2][1], two[4][1]
    loss, steps, _ = two[3]
    _close(loss, want_off, "offload -> device")
    assert steps == STEPS + 1
    loss, steps, _ = two[5]
    _close(loss, want_dev, "device -> offload")
    assert steps == STEPS + 1


def test_port_offload_save_resumes_at_one_rank_and_in_jax(runs):
    want = runs["two"][0][2][1]
    loss, steps = runs["one_rank"]["port2"]
    _close(loss, want, "port 2 -> port 1")
    assert steps == STEPS + 1
    loss, steps = runs["jax_resumes_port2"]
    _close(loss, want, "port 2 -> jax 2")
    assert steps == STEPS + 1


def test_jax_offload_save_resumes_in_the_port_at_two_and_one(runs):
    want = runs["jax"][(2, "s2")][5]
    for rank in runs["two"]:
        loss, steps, masters = rank[6]
        _close(loss, want, "jax 2 -> port 2")
        assert steps == STEPS + 1
    _masters_close(runs["two"][0][6][2], runs["jax"][(2, "s2")][1],
                   "jax 2 masters")
    loss, steps = runs["one_rank"]["jax2"]
    _close(loss, want, "jax 2 -> port 1")
    assert steps == STEPS + 1


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_streamed_tier_on_strided_slices_matches_fused_adam(cuda_device):  # noqa: F811
    """A rank's slices (dim 0 and dim 1 cuts, so strided views) through
    the streamed tier (pinned host state, two device slots, small units:
    several groups) against FusedAdam.step on the same slices on the
    card: the bf16 compute copy and the fp32 state bit for bit after
    three steps, and the rest of each leaf untouched."""
    from deepspeed_tpu_torch.ops.adam import FusedAdam
    from deepspeed_tpu_torch.runtime.zero.offload_stream import \
        StreamedOffloadOptimizer
    dev, n, rank = cuda_device, 4, 2
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes, plan = [(64, 96), (32, 160), (96,), (8, 40, 12)], \
        [(0, 16), (1, 40), (0, 24), (1, 10)]
    full = [torch.randn(s, generator=gen, device=dev) for s in shapes]

    def mine(ts):
        return [t.narrow(d, rank * k, k) for t, (d, k) in zip(ts, plan)]
    opt = FusedAdam(lr=1e-3, weight_decay=0.01)
    masters = [t.clone() for t in mine(full)]
    state = opt.init(masters)
    compute = [t.to(torch.bfloat16) for t in full]
    before = [t.clone() for t in compute]
    tier = StreamedOffloadOptimizer(mine(full), opt, dev,
                                    unit_bytes=4 * 1024)
    assert len(tier.groups) > 2
    for step in range(3):
        grads = [torch.randn(t.shape, generator=gen, device=dev)
                 for t in masters]
        lr = torch.tensor(1e-3, device=dev)
        scale = torch.tensor(0.5, device=dev)
        # both steps use their gradient lists as scratch
        opt.step(masters, [g.clone() for g in grads], state, lr,
                 grad_scale=scale)
        tier.step([g.clone() for g in grads], mine(compute), lr,
                  grad_scale=scale)
    torch.cuda.synchronize()
    sd = tier.state_dict()
    for got, want in zip(tier.master_leaves(), masters):
        assert torch.equal(got, want.cpu())
    for k in ("exp_avg", "exp_avg_sq"):
        for got, want in zip(sd[k], state[k]):
            assert torch.equal(got, want.float().cpu())
    for c, b, m, (d, k) in zip(compute, before, masters, plan):
        assert torch.equal(c.narrow(d, rank * k, k), m.to(torch.bfloat16))
        rest = torch.ones(c.shape, dtype=torch.bool, device=dev)
        rest.narrow(d, rank * k, k).fill_(False)
        assert torch.equal(c[rest], b[rest])
    tier.close()
