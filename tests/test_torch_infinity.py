"""deepspeed_tpu_torch's ZeRO-Infinity engine vs the JAX package's, on the CPU.

``runtime/zero/infinity.py`` against ``deepspeed_tpu.runtime.zero.infinity``
on a tiny GPT-2 (vocab 512, E 64, 4 layers, 2 heads, fp32, S 24): the
client init bit for bit, 4-step trajectories (losses, masters and both
moments) at fp32 2e-5 with exp_avg in fp32 and in bf16, K = 1, 2 and 4
equal, the ``initialize()`` dispatch and its refusals, the durable NVMe
files restoring across the two packages both ways, the per-step park,
and ``swap_in_stream`` reading JAX-written files as JAX does. On the
card (``gpu``): the pinned parameter arena, and segment-streamed steps
against each other and against the main engine's first update
(``python -m pytest --noconftest -m gpu tests/test_torch_infinity.py``;
JAX is imported inside the tests that use it).
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.swap_tensor.swapper import \
    PartitionedParamSwapper
from deepspeed_tpu_torch.runtime.zero import infinity as tinf
from torch_port_common import assert_close, cuda_device  # noqa: F401

GEOM = dict(vocab_size=512, n_positions=64, n_embd=64, n_layer=4, n_head=2,
            scan_layers=True)
LR, WD, STEPS = 1e-3, 0.01, 4
E = GEOM["n_embd"]


def _jax():
    """(jax, jax.numpy, the JAX GPT-2 module, the JAX infinity module),
    imported here so the gpu tests run where JAX is not installed."""
    jax = importlib.import_module("jax")
    return (jax, importlib.import_module("jax.numpy"),
            importlib.import_module("deepspeed_tpu.models.gpt2"),
            importlib.import_module("deepspeed_tpu.runtime.zero.infinity"))


def _jcfg():
    _, jnp, jgpt2, _ = _jax()
    return jgpt2.GPT2Config(dtype=jnp.float32, param_dtype=jnp.float32,
                            **GEOM)


def _tcfg(**kw):
    return tgpt2.GPT2Config(**{**GEOM, "dtype": torch.float32,
                               "param_dtype": torch.float32, **kw})


def _batch(seed=0, seq=24):
    return {"input_ids": np.random.RandomState(seed).randint(
        0, GEOM["vocab_size"], size=(2, seq)).astype(np.int32)}


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict, in JAX's flatten order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else x,
                      np.float32)


def _jax_engine(params, segments=2, mdtype="fp32", **kw):
    _, jnp, _, jinf = _jax()
    return jinf.InfinityEngine(
        _jcfg(), params, segments=segments, lr=LR, weight_decay=WD,
        moment_dtype=jnp.float32 if mdtype == "fp32" else jnp.bfloat16,
        **kw)


def _port_engine(params, segments=2, mdtype="fp32", **kw):
    return tinf.InfinityEngine(_tcfg(), params, device="cpu",
                               segments=segments, lr=LR, weight_decay=WD,
                               moment_dtype=mdtype, **kw)


def _jax_state(je):
    """(masters, exp_avg, exp_avg_sq) of the JAX engine as flat dicts."""
    jax = _jax()[0]
    masters = _flat(jax.tree_util.tree_map(np.asarray, je.params_tree()))
    blk_paths = [p for p in masters if p[0] == "h"]
    emb_paths = [p for p in masters if p[0] != "h"]
    out = [masters]
    for rows, emb in ((je.m, je.emb_m), (je.v, je.emb_v)):
        d = {p: np.stack([_np(rows[r][i]) for r in range(len(rows))])
             for i, p in enumerate(blk_paths)}
        d.update({p: _np(x) for p, x in zip(emb_paths, emb)})
        out.append(d)
    return out


def _port_state(te):
    m, v = te.moments_tree()
    return [_flat(te.params_tree()), _flat(m), _flat(v)]


# the key third of c_attn's bias: its gradient is zero in exact arithmetic
# (softmax is invariant to a constant added to every score of a query),
# so each side's is its own rounding noise (~1e-10), which Adam scales by
# 1/(sqrt(v) + eps) to a step of up to lr. There the masters are held to
# the most Adam can move them, lr a step; every other element at 2e-5.
KEY_BIAS = slice(E, 2 * E)


def _hold_states(te, je, steps):
    for name, got, want in zip(("master", "exp_avg", "exp_avg_sq"),
                               _port_state(te), _jax_state(je)):
        assert got.keys() == want.keys()
        for path in want:
            g, w = _np(got[path]), want[path]
            if path[-2:] == ("c_attn", "bias"):
                if name == "master":
                    np.testing.assert_allclose(g[:, KEY_BIAS],
                                               w[:, KEY_BIAS],
                                               atol=steps * LR)
                g, w = np.delete(g, KEY_BIAS, 1), np.delete(w, KEY_BIAS, 1)
            assert_close(g, w)


def test_client_init_bit_for_bit_and_tiled_init():
    jax, _, jgpt2, jinf = _jax()
    cfg = _tcfg()
    want = _flat(jax.tree_util.tree_map(np.asarray,
                                        jinf.gpt2_client_init(_jcfg(), 5)))
    got = _flat(tinf.gpt2_client_init(cfg, 5))
    assert list(got) == list(want)
    for path, w in want.items():
        assert np.array_equal(got[path].numpy(), w), path
    bench = importlib.import_module("bench")
    want = _flat(jax.tree_util.tree_map(np.asarray,
                                        bench.tiled_gpt2_init(_jcfg(), 2)))
    got = _flat(tinf.tiled_gpt2_init(cfg, 2))
    for path, w in want.items():
        assert np.array_equal(got[path].numpy(), w), path
    kernel = got[("h", "blk", "mlp", "c_fc", "kernel")]
    assert kernel.stride(0) == 0        # one layer, broadcast


@pytest.mark.parametrize("mdtype", ["fp32", "bf16"])
def test_trajectory_matches_jax_engine(mdtype):
    """4 steps of AdamW at K = 2: losses, masters, exp_avg (stored in
    ``mdtype``) and exp_avg_sq at fp32 2e-5."""
    params = _jax()[3].gpt2_client_init(_jcfg(), 1)
    je = _jax_engine(params, mdtype=mdtype)
    te = _port_engine(tinf.gpt2_client_init(_tcfg(), 1), mdtype=mdtype)
    for step in range(STEPS):
        b = _batch(step)
        assert te.train_batch(b) == pytest.approx(je.train_batch(b),
                                                  rel=2e-5, abs=2e-5)
    _hold_states(te, je, STEPS)


def test_segment_counts_give_one_trajectory():
    """Each row's update does not depend on the segmentation: K = 1, 2
    and 4 give the same losses and masters bit for bit."""
    runs = []
    for k in (1, 2, 4):
        te = _port_engine(tinf.gpt2_client_init(_tcfg(), 2), segments=k)
        losses = [te.train_batch(_batch(i)) for i in range(3)]
        runs.append((losses, _flat(te.params_tree())))
    for losses, masters in runs[1:]:
        assert losses == runs[0][0]
        for path, m in masters.items():
            assert torch.equal(m, runs[0][1][path]), path


def _ds_config(**over):
    cfg = {"train_batch_size": 2,
           "zero_optimization": {"stage": 3, "offload_param": {
               "device": "cpu", "stream_segments": 2},
               "offload_optimizer": {"device": "cpu"}},
           "optimizer": {"type": "AdamW",
                         "params": {"lr": LR, "weight_decay": WD}}}
    cfg.update(over)
    return cfg


def test_initialize_dispatch_matches_jax():
    """``stream_segments > 0`` returns (InfinityEngine, None, None, None)
    with the config's Adam and exp_avg in bf16, as JAX's; its first steps
    equal JAX's from the same seed (``model_parameters=None``: the client
    init)."""
    import deepspeed_tpu as dstpu
    _, _, jgpt2, _ = _jax()
    cfg = _ds_config(seed=7)
    je, *rest_j = dstpu.initialize(config=cfg,
                                   model=jgpt2.GPT2LMHeadModel(_jcfg()))
    te, *rest_t = dst.initialize(config=cfg,
                                 model=tgpt2.GPT2LMHeadModel(_tcfg()),
                                 device="cpu")
    assert isinstance(te, tinf.InfinityEngine)
    assert rest_t == rest_j == [None, None, None]
    assert te.K == je.K == 2 and te._row.mdtype == torch.bfloat16
    for step in range(2):
        b = _batch(step)
        assert te.train_batch(b) == pytest.approx(je.train_batch(b),
                                                  rel=2e-5)


def test_initialize_refusals():
    """JAX's ValueError for what the engine does not take; a ValueError
    for a model it does not stream, and from the main engine for bf16
    master parameters; NotImplementedError, naming ROADMAP, for what
    JAX's engine would silently ignore."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
    model = tgpt2.GPT2LMHeadModel(_tcfg())
    with pytest.raises(ValueError) as got:
        dst.initialize(config=_ds_config(), model=model, device="cpu",
                       loss_fn=lambda m, b: 0, lr_scheduler=lambda s: 1.0)
    assert str(got.value) == (
        "offload_param.stream_segments selects the ZeRO-Infinity "
        "segment-streamed engine, which does not accept ['lr_scheduler', "
        "'loss_fn']; it builds its Adam/AdamW step and tied-LM loss from "
        "the config (runtime/zero/infinity.py)")
    with pytest.raises(ValueError, match="streams GPT-2"):
        dst.initialize(config=_ds_config(), model=LlamaForCausalLM(
            llama_tiny()), device="cpu")
    with pytest.raises(ValueError, match="scan-stacked"):
        dst.initialize(config=_ds_config(), model=tgpt2.GPT2LMHeadModel(
            _tcfg(scan_layers=False)), device="cpu")
    bad = _ds_config()
    bad["zero_optimization"]["offload_param"]["stream_segments"] = 3
    with pytest.raises(ValueError, match="must divide n_layer"):
        dst.initialize(config=bad, model=model, device="cpu")
    with pytest.raises(ValueError, match="keeps fp32 master parameters"):
        dst.initialize(config={"train_batch_size": 2},  # the main engine
                       model=tgpt2.GPT2LMHeadModel(_tcfg(
                           param_dtype=torch.bfloat16)), device="cpu")
    for over in ({"gradient_clipping": 1.0}, {"fp16": {"enabled": True}},
                 {"train_batch_size": 4, "gradient_accumulation_steps": 2},
                 {"scheduler": {"type": "WarmupLR", "params": {}}}):
        with pytest.raises(NotImplementedError,
                           match="InfinityEngine ignores"):
            dst.initialize(config=_ds_config(**over), model=model,
                           device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_durable_files_restore_across_packages(writer, tmp_path):
    """3 steps in one package, ``park_to_nvme``, then a fresh engine of
    the other package (and one of the same) restores the masters from
    the durable files: its next loss is JAX's restored engine's, and
    below the first."""
    params = _jax()[3].gpt2_client_init(_jcfg(), 2)
    tparams = tinf.gpt2_client_init(_tcfg(), 2)
    kw = dict(nvme_path=str(tmp_path), park_threshold_bytes=0)
    first = (_jax_engine if writer == "jax" else _port_engine)(
        params if writer == "jax" else tparams, **kw)
    losses = [first.train_batch(_batch(i)) for i in range(3)]
    first.park_to_nvme()
    assert first.params_on_disk_bytes() > 0
    del first
    je = _jax_engine(params, restore_params=True, **kw)
    te = _port_engine(None, restore_params=True, **kw)
    for path, m in _flat(te.params_tree()).items():
        assert_close(m, _flat(je.params_tree())[path], atol=0, rtol=0)
    lj, lt = je.train_batch(_batch(3)), te.train_batch(_batch(3))
    assert lt == pytest.approx(lj, rel=2e-5) and lt < losses[0]
    te.release()
    assert not os.path.exists(os.path.join(str(tmp_path), "infinity_params",
                                           "param_0.swp"))


def test_per_step_park_under_the_threshold(tmp_path):
    """At or under ``park_threshold_bytes`` the files are rewritten every
    step from the updated masters; above it, only by park_to_nvme."""
    te = _port_engine(tinf.gpt2_client_init(_tcfg(), 3),
                      nvme_path=str(tmp_path / "a"))
    assert te.param_bytes <= te._park_threshold
    sw = te._swapper
    before = _read(sw, 5)
    te.train_batch(_batch())
    assert not torch.equal(_read(sw, 5), before)
    assert torch.equal(_read(sw, 5), te.params_tree()["h"]["blk"]["attn"][
        "c_attn"]["kernel"])
    big = _port_engine(tinf.gpt2_client_init(_tcfg(), 3),
                       nvme_path=str(tmp_path / "b"), park_threshold_bytes=1)
    kept = _read(big._swapper, 5)
    big.train_batch(_batch())
    assert torch.equal(_read(big._swapper, 5), kept)
    big.park_to_nvme()
    assert not torch.equal(_read(big._swapper, 5), kept)


def _read(sw, i):
    shape, dtype = sw.meta[i]
    raw = torch.empty(sw._leaf_nbytes(i), dtype=torch.uint8)
    sw.handle.sync_pread(raw, sw._path(i))
    return raw.view(dtype).view(shape).clone()


@pytest.mark.parametrize("pipeline_read", [False, True])
def test_swap_in_stream_matches_jax_on_the_same_files(pipeline_read,
                                                      tmp_path):
    """JAX's swapper writes mixed-dtype leaves (a generator, one leaf in
    hand); the port's ``swap_in_stream`` yields the same bytes in the
    same order, through a window of at most its staging slots; a leaf
    still being written behind is drained first, and ``staged_leaf``
    serves the write-behind cache."""
    jsw_mod = importlib.import_module(
        "deepspeed_tpu.runtime.swap_tensor.swapper")
    jnp = _jax()[1]
    rs = np.random.RandomState(0)
    leaves = [rs.randn(*s).astype(d) for s, d in (
        ((33, 7), np.float32), ((5,), np.float32), ((64, 9), jnp.bfloat16),
        ((1000,), np.float32), ((3, 4, 5), jnp.bfloat16))]
    jsw = jsw_mod.PartitionedParamSwapper(str(tmp_path), sub_dir="s",
                                          durable=True)
    jsw.write_all(x for x in leaves)
    order = [3, 0, 4, 1, 2]
    want = [(i, np.asarray(v, np.float32).copy())
            for i, v in jsw.swap_in_stream(order)]
    sw = PartitionedParamSwapper(str(tmp_path), sub_dir="s", durable=True,
                                 pipeline_read=pipeline_read,
                                 buffer_count=3)
    sw.load_meta()
    got = [(i, v.float().numpy().copy()) for i, v in
           sw.swap_in_stream(order)]
    assert [i for i, _ in got] == order
    for (_, g), (_, w) in zip(got, want):
        assert np.array_equal(g, w)
    slots = [b for b in sw._staging if b is not None]
    most = max(sw.handle.io_nbytes(x.nbytes) for x in leaves)
    assert len(sw._staging) == (3 if pipeline_read else 2)
    assert sum(b.numel() for b in slots) <= len(slots) * most
    pw = PartitionedParamSwapper(str(tmp_path / "w"), pipeline_write=True)
    pw.write_all([torch.zeros(4)])
    pw.write_behind(0, torch.arange(4.0))
    assert pw.has_pending_writes
    value, source = pw.staged_leaf(0)
    assert source == "cache" and torch.equal(value, torch.arange(4.0))
    assert [v.tolist() for _, v in pw.swap_in_stream()] == [[0, 1, 2, 3]]
    assert not pw.has_pending_writes


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
def test_pinned_param_arena_round_trip_on_the_card(cuda_device):
    """offload_param cpu's arena: tensors park into page-locked memory on
    a copy stream and come back equal; the card's memory is freed
    between."""
    from deepspeed_tpu_torch.runtime.zero.pinned import HostParamRest
    rest = HostParamRest(cuda_device)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ts = [torch.randn(s, generator=gen, device="cuda").to(d) for s, d in (
        ((1000, 37), torch.float32), ((3,), torch.bfloat16),
        ((4096,), torch.float32))]
    want = [t.clone() for t in ts]
    rest.park(ts)
    assert rest._buf.pinned and rest._views[0].is_pinned()
    del ts
    back = rest.unpark()
    for b, w in zip(back, want):
        assert b.device.type == "cuda" and torch.equal(b, w)
    assert all(x >= 0 for x in rest.last_ms())
    rest.close()


@pytest.mark.gpu
def test_segment_streamed_step_on_the_card(cuda_device):
    """The streamed step on the card (pinned state, copy streams, the
    flash kernels at bf16, head dim 64): K = 1 and 2 agree bit for bit
    over 3 steps, and the first update equals the main engine's device
    FusedAdam from the same weights bit for bit in every leaf but wte,
    whose two gradients the Infinity engine sums in fp32 (the main
    engine in bf16)."""
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.ops.cuda import tolerance
    cfg = tgpt2.GPT2Config(vocab_size=512, n_positions=64, n_embd=128,
                           n_layer=4, n_head=2, dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16)
    params = tinf.gpt2_client_init(cfg, 4)
    bridge = tgpt2.GPT2LMHeadModel(cfg)
    before = {k: v.float() for k, v in bridge.from_jax_tree(params).items()}
    runs = {}
    for k, steps in ((1, 3), (2, 3), (2, 1)):
        te = tinf.InfinityEngine(cfg, params, segments=k, lr=LR,
                                 moment_dtype="fp32")
        assert te._host.pinned
        runs[k, steps] = ([te.train_batch(_batch(i)) for i in range(steps)],
                          bridge.from_jax_tree(te.params_tree()))
        te.close()
    assert runs[1, 3][0] == runs[2, 3][0]
    for name, m in runs[1, 3][1].items():
        assert torch.equal(m, runs[2, 3][1][name]), name
    main, _, _, _ = ds.initialize(
        config={"train_batch_size": 2, "bf16": {"enabled": True},
                "data_types": {"grad_dtype": "bf16"},
                "optimizer": {"type": "AdamW", "params": {
                    "lr": LR, "moment_dtype": "fp32"}}},
        model=tgpt2.GPT2LMHeadModel(dataclasses.replace(
            cfg, param_dtype=torch.float32)),
        model_parameters=before)
    assert float(main.train_batch(_batch(0))) == runs[2, 1][0][0]
    got = runs[2, 1][1]
    for name, m in main.gather_master().items():
        if name == "wte":
            assert tolerance.row_rel_err(
                got[name] - before[name], m - before[name],
                tolerance.OFFLOAD_UPDATE_FLOOR) <= \
                tolerance.INFINITY_UPDATE_RTOL["wte"]
        else:
            assert torch.equal(got[name], m), name
