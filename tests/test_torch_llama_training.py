"""deepspeed_tpu_torch LLaMA training and generate vs the JAX package.

The same weights (drawn by the JAX model's init, carried across by the
port's bridge) and the same seeded token batches go through both
packages at fp32 on the CPU, at ``llama_tiny`` (GQA: 4 heads, 2 KV heads)
and its MHA variant: logits, losses (plain and chunked over the untied
head) and every gradient leaf in both tree layouts; ``initialize`` +
``train_batch`` trajectories against the JAX engine on a 1-device CPU
mesh; checkpoints across the two packages; ``llama_generate`` token for
token; and a port-trained tree served by the paged engine. On the card,
a remat step launches the flash forward twice a layer.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.gpt2 import lm_loss
from deepspeed_tpu_torch.ops.cuda import builder
from torch_port_common import assert_close, cuda_device  # noqa: F401

VOCAB, SEQ = 512, 16
KV_HEADS = [2, 0]           # llama_tiny's GQA, and MHA


def _jax(name):
    """A module of jax or of the JAX package, imported here and not at the
    top so the gpu tests also run where JAX is not installed."""
    return importlib.import_module(name)


def _np32(tree):
    jax = _jax("jax")
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _jcfg(**kw):
    jnp = _jax("jax.numpy")
    kw.setdefault("dtype", jnp.float32)
    return _jax("deepspeed_tpu.models.llama").llama_tiny(**kw)


def _jax_model(n_kv_heads=2, scan_layers=True, **kw):
    jax = _jax("jax")
    jllama = _jax("deepspeed_tpu.models.llama")
    model = jllama.LlamaForCausalLM(_jcfg(n_kv_heads=n_kv_heads,
                                          scan_layers=scan_layers, **kw))
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, SEQ), np.int32))["params"]
    return model, params


def _port_cfg(n_kv_heads=2, scan_layers=True, dtype=torch.float32, **kw):
    return tllama.llama_tiny(n_kv_heads=n_kv_heads, scan_layers=scan_layers,
                             dtype=dtype, **kw)


def _port_model(params, n_kv_heads=2, scan_layers=True, **kw):
    model = tllama.LlamaForCausalLM(
        _port_cfg(n_kv_heads, scan_layers, **kw), device="cpu")
    model.load_state_dict(model.from_jax_tree(_np32(params)))
    return model


def _ids(batch=4, seed=0, seq=SEQ):
    return np.random.RandomState(seed).randint(
        0, VOCAB, size=(batch, seq)).astype(np.int32)


@pytest.mark.parametrize("n_kv_heads", KV_HEADS)
@pytest.mark.parametrize("scan_layers", [True, False])
def test_model_logits_losses_and_grads_match_jax(scan_layers, n_kv_heads):
    jax = _jax("jax")
    jgpt2 = _jax("deepspeed_tpu.models.gpt2")
    jllama = _jax("deepspeed_tpu.models.llama")
    jmodel, params = _jax_model(n_kv_heads, scan_layers)
    ids = _ids()

    jchunk = jllama.LlamaForCausalLM(_jcfg(
        n_kv_heads=n_kv_heads, scan_layers=scan_layers, loss_chunk=24))

    @jax.jit
    def jall(p):
        def jloss(p):
            logits = jmodel.apply({"params": p}, ids)
            return jgpt2.lm_loss(logits, ids), logits
        (loss, logits), grads = jax.value_and_grad(jloss, has_aux=True)(p)
        return logits, loss, grads, jax.value_and_grad(
            lambda p: jchunk.apply({"params": p}, ids, labels=ids))(p)
    logits_j, loss_j, grads_j, (chunk_j, cgrads_j) = jall(params)

    model = _port_model(params, n_kv_heads, scan_layers)
    tids = torch.from_numpy(ids)
    assert_close(model(tids), np.asarray(logits_j))
    loss = lm_loss(model(tids), tids)
    assert_close(loss, np.asarray(loss_j))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = model.from_jax_tree(_np32(grads_j))
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        assert_close(g, want[name])

    chunked = tllama.LlamaForCausalLM(
        _port_cfg(n_kv_heads, scan_layers, loss_chunk=24), device="cpu")
    chunked.load_state_dict(model.state_dict())
    loss_c = chunked(tids, labels=tids)          # 60 tokens: a padded chunk
    assert_close(loss_c, np.asarray(chunk_j))
    grads_c = torch.autograd.grad(loss_c, list(chunked.parameters()))
    want_c = chunked.from_jax_tree(_np32(cgrads_j))
    for name, g in zip(names, grads_c):
        assert_close(g, want_c[name])


@pytest.mark.parametrize("n_kv_heads", KV_HEADS)
def test_bridge_roundtrips_both_layouts_and_remat_keeps_grads(n_kv_heads):
    jax = _jax("jax")
    _, params = _jax_model(n_kv_heads)
    model = _port_model(params, n_kv_heads)
    named = {k: v.detach() for k, v in model.named_parameters()}
    for scan in (True, False):
        tree = model.jax_tree(named, scan_layers=scan)
        assert ("layers" in tree) == scan
        assert ("layers_1" in tree) == (not scan)
        back = model.from_jax_tree(tree)
        for k, v in named.items():
            assert torch.equal(back[k], v)
    tree = model.jax_tree(named)
    leaves = jax.tree_util.tree_leaves_with_path(_np32(params))
    assert len(leaves) == 9 + 3     # the stacked block leaves, the outer 3
    for path, leaf in leaves:
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    # the [in, out] orientation the serving weights pack
    from deepspeed_tpu_torch.models import llama_inference
    packed = llama_inference.convert_llama_serving_params(_np32(params),
                                                          model.config)
    np.testing.assert_array_equal(
        packed["blk"]["qkv_w"]["kernel"][0, :, :128],
        named["layers.0.attn.q_proj.kernel"].numpy())

    tids = torch.from_numpy(_ids())
    remat = _port_model(params, n_kv_heads, remat=True)
    g0 = torch.autograd.grad(model(tids, labels=tids),
                             list(model.parameters()))
    g1 = torch.autograd.grad(remat(tids, labels=tids),
                             list(remat.parameters()))
    for a, b in zip(g0, g1):
        assert_close(a, b)


def test_model_refuses_what_is_not_ported():
    """A named remat policy and bf16 masters raise naming what is
    missing; a mesh seq axis (ring / Ulysses attention) is refused where
    the mesh is made."""
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item "
                       "\"Named remat policies"):
        tllama.LlamaForCausalLM(_port_cfg(remat=True, remat_policy="dots"))
    with pytest.raises(NotImplementedError, match="fp32 master"):
        tllama.LlamaForCausalLM(_port_cfg(param_dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="Long context"):
        make_mesh(MeshConfig(seq=2), device="cpu")


def test_attention_function_swaps_and_use_flash_false_is_plain():
    """``LlamaAttention.attention`` set on an instance replaces the
    attention function, K/V at Hkv heads (chip_smoke's grad check swaps
    in the plain flash versions so); the flash Function on the CPU gives
    the reference loss and gradients at fp32 2e-5. ``use_flash=False``
    runs ``reference_attention`` whatever the instance holds."""
    from deepspeed_tpu_torch.ops.attention import FlashAttentionFunction
    _, params = _jax_model()
    model = _port_model(params)
    tids = torch.from_numpy(_ids())
    want_loss = model(tids, labels=tids)
    want = torch.autograd.grad(want_loss, list(model.parameters()))
    calls = []

    def flash(q, k, v, causal=False):
        calls.append((q.shape[1], k.shape[1]))
        return FlashAttentionFunction.apply(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal)
    for block in model.layers:
        block.attn.attention = flash
    got_loss = model(tids, labels=tids)
    got = torch.autograd.grad(got_loss, list(model.parameters()))
    assert calls == [(4, 2)] * len(model.layers)
    assert_close(got_loss, want_loss)
    for a, b in zip(got, want):
        assert_close(a, b)
    plain = _port_model(params, use_flash=False)
    for block in plain.layers:
        block.attn.attention = flash
    assert_close(plain(tids, labels=tids), want_loss)
    assert len(calls) == len(model.layers)


def test_seeded_init_is_reproducible_and_on_scale():
    cfg = _port_cfg()
    a, b = (tllama.LlamaForCausalLM(cfg, device="cpu") for _ in range(2))
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(3))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
        if n.endswith("scale"):
            assert torch.equal(p, torch.ones_like(p))
        else:
            assert abs(float(p.std()) - 0.02) < 2e-3, n


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


def _bf16_config():
    return _config(bf16={"enabled": True}, data_types={"grad_dtype": "bf16"},
                   optimizer={"type": "AdamW",
                              "params": {"lr": 3e-3, "weight_decay": 0.01,
                                         "moment_dtype": "bf16"}},
                   gradient_accumulation_steps=1)


def _jax_engine(cfg, params, **model_kw):
    jax = _jax("jax")
    dstpu = _jax("deepspeed_tpu")
    mesh_lib = _jax("deepspeed_tpu.parallel.mesh")
    jllama = _jax("deepspeed_tpu.models.llama")
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(data=1),
                              devices=jax.devices()[:1])
    engine, _, _, _ = dstpu.initialize(
        config=cfg, model=jllama.LlamaForCausalLM(_jcfg(**model_kw)),
        model_parameters=params, mesh=mesh)
    return engine


def _port_engine(cfg, params, **model_kw):
    model = tllama.LlamaForCausalLM(_port_cfg(**model_kw))
    engine, _, _, _ = dst.initialize(
        config=cfg, model=model,
        model_parameters=model.from_jax_tree(_np32(params)), device="cpu")
    return engine


def _batches(n, batch=4):
    return [{"input_ids": _ids(batch, seed=i)} for i in range(n)]


def test_train_batch_trajectory_matches_jax_engine_fp32():
    """5 steps of AdamW with gas 2, clipping and WarmupDecayLR, GQA: equal
    losses, lr and grad norms at rtol 2e-5, and equal weights after, each
    element within 5e-5 (1/60 of the peak lr): an embedding element whose
    summed gradient cancels to ~1e-9 (exp_avg_sq ~1e-18, under Adam's eps
    of 1e-8) carries its relative rounding error into the update, 2.1e-5
    against JAX with XLA's optimizations off."""
    jax = _jax("jax")
    _, params = _jax_model()
    cfg = _config()
    je, te = _jax_engine(cfg, params), _port_engine(cfg, params)
    for batch in _batches(5):
        lj = float(je.train_batch(batch))
        assert float(te.train_batch(batch)) == pytest.approx(lj, rel=2e-5)
        assert te.get_lr()[0] == pytest.approx(je.get_lr()[0], rel=2e-5)
        assert float(te.get_global_grad_norm()) == pytest.approx(
            float(je.get_global_grad_norm()), rel=2e-5)
    assert te.global_steps == je.global_steps == 5
    want = te.module.from_jax_tree(_np32(jax.device_get(je.state.params)))
    for name, m in zip(te.param_names, te.master):
        assert_close(m, want[name], atol=5e-5, rtol=2e-5)


def test_train_batch_trajectory_matches_jax_engine_bf16():
    """bf16 compute with grad_dtype and moment_dtype bf16 and the chunked
    loss over the untied head (chip_smoke's train_llama config): losses
    within 5e-2; gradients come out bf16, exp_avg is stored bf16."""
    jnp = _jax("jax.numpy")
    _, params = _jax_model()
    cfg = _bf16_config()
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


def _same_leaves(a_dir, b_dir):
    jax = _jax("jax")
    jckpt = _jax("deepspeed_tpu.runtime.checkpointing")
    astate, ameta = jckpt.load_checkpoint(str(a_dir))
    bstate, bmeta = jckpt.load_checkpoint(str(b_dir))
    al = jax.tree_util.tree_leaves_with_path(astate)
    bl = dict(jax.tree_util.tree_leaves_with_path(bstate))
    assert len(al) == len(bl)
    for path, leaf in al:
        got = bl[path]
        assert np.asarray(got).dtype == np.asarray(leaf).dtype, path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf))
    assert ameta["global_steps"] == bmeta["global_steps"]


def test_checkpoints_cross_both_ways(tmp_path):
    """JAX saves at step 3 and the port resumes; the port saves at step 3
    and JAX resumes: both continuations match the writer's own steps 4-6
    at rtol 2e-5, and the two packages' checkpoints of the same state are
    equal leaf for leaf."""
    _, params = _jax_model()
    params = _np32(params)
    cfg = _config()
    batches = _batches(6)
    je, te = _jax_engine(cfg, params), _port_engine(cfg, params)
    for b in batches[:3]:
        je.train_batch(b)
        te.train_batch(b)
    je.save_checkpoint(str(tmp_path / "jax"))
    te.save_checkpoint(str(tmp_path / "port"))
    te2 = _port_engine(cfg, params)
    tag, _ = te2.load_checkpoint(str(tmp_path / "jax"))
    assert tag == "global_step3" and te2.global_steps == 3
    te2.save_checkpoint(str(tmp_path / "port_of_jax"))
    _same_leaves(tmp_path / "jax", tmp_path / "port_of_jax")
    jax_own = [float(je.train_batch(b)) for b in batches[3:]]
    port_own = [float(te.train_batch(b)) for b in batches[3:]]
    tag, _ = je.load_checkpoint(str(tmp_path / "port"))
    assert tag == "global_step3" and je.global_steps == 3
    for b, lj, lt in zip(batches[3:], jax_own, port_own):
        assert float(te2.train_batch(b)) == pytest.approx(lj, rel=2e-5)
        assert float(je.train_batch(b)) == pytest.approx(lt, rel=2e-5)


# -- generate and serving -----------------------------------------------------

@pytest.mark.parametrize("n_kv_heads", KV_HEADS)
def test_llama_generate_matches_jax_and_full_reforwards(n_kv_heads):
    """Greedy, B 2, a prompt of 8, 6 new tokens: token for token JAX's
    ``llama_generate``, and each new token the argmax of a full
    re-forward of everything before it."""
    jllama = _jax("deepspeed_tpu.models.llama")
    _, params = _jax_model(n_kv_heads)
    prompt = _ids(2, seed=7, seq=8)
    want = np.asarray(jllama.llama_generate(
        _jcfg(n_kv_heads=n_kv_heads), params, prompt, max_new_tokens=6))
    model = _port_model(params, n_kv_heads)
    got = tllama.llama_generate(model, prompt, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad():
        for t in range(8, 14):
            nxt = model(got[:, :t]).argmax(-1)[:, -1]
            assert torch.equal(nxt, got[:, t].long())
    assert torch.equal(tllama.llama_generate(model, prompt, 0),
                       torch.from_numpy(prompt))
    sampled = [tllama.llama_generate(
        model, prompt, 6, temperature=0.8,
        generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    assert torch.equal(sampled[0], sampled[1])
    with pytest.raises(ValueError, match="exceed"):
        tllama.llama_generate(model, prompt, 121)


def test_cache_overflow_gives_nan_as_jax():
    """A decode write past the cache's end: the query is NaN (JAX's
    overflow contract, llama.py:169) and the write is clamped into the
    cache."""
    _, params = _jax_model()
    model = _port_model(params)
    cache = tllama.LlamaKVCache(model.config, 1, 8, torch.float32, "cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(_ids(1, seq=8)), cache=cache)
        assert torch.isfinite(out).all() and cache.index == 8
        out = model(torch.zeros(1, 1, dtype=torch.long), cache=cache,
                    position_offset=8)
    assert torch.isnan(out).all() and cache.index == 9


def test_port_trained_weights_serve():
    """A tiny model trained by the port's engine: its JAX tree packs into
    the serving weights, and the paged engine's greedy tokens equal
    ``llama_generate``'s on the same prompts."""
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.models import llama_inference
    _, params = _jax_model()
    te = _port_engine(_config(), params)
    for b in _batches(3):
        te.train_batch(b)
    cfg = te.module.config
    tree = te.module.jax_tree(dict(zip(te.param_names, te.master)))
    sparams = llama_inference.from_jax_serving_params(tree, cfg, "cpu")
    eng = serving.build_engine(
        "llama", cfg, sparams, device="cpu",
        config={"serving": {"slots": 2, "page_size": 16,
                            "max_pages_per_slot": 4}})
    prompts = [_ids(1, seed=20 + i, seq=s)[0] for i, s in enumerate((5, 11))]
    res = eng.serve([serving.Request(i, p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
    for i, prompt in enumerate(prompts):
        want = tllama.llama_generate(te.module, prompt[None], 6)
        np.testing.assert_array_equal(res[i].tokens(), want[0].numpy())


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n_kv_heads", [2, 0])
def test_cuda_remat_step_launches_and_grads(cuda_device, n_kv_heads):
    """A bf16 remat step of a 2-layer LLaMA at head dim 128 on the card:
    the flash forward launches twice a layer (again in the recompute),
    the backward and its delta once; the loss and every gradient leaf
    agree with the same step through ``reference_attention`` within the
    grad check's row-relative limit (3e-2)."""
    from deepspeed_tpu_torch.ops.attention import reference_attention
    from deepspeed_tpu_torch.ops.cuda import tolerance
    cfg = tllama.llama_tiny(hidden_size=512, intermediate_size=1024,
                            n_heads=4, n_kv_heads=n_kv_heads,
                            dtype=torch.bfloat16, remat=True,
                            loss_chunk=256, max_seq_len=512)
    model = tllama.LlamaForCausalLM(cfg, device=cuda_device)
    model.reset_parameters(torch.Generator(cuda_device).manual_seed(0))
    ids = torch.from_numpy(_ids(2, seq=512)).to(cuda_device)
    params = list(model.parameters())
    builder.launches.clear()
    loss = model(ids, labels=ids)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    assert dict(builder.launches) == {
        "flash_attention_fwd": 4, "flash_attention_bwd": 2,
        "flash_attention_bwd_delta": 2}, dict(builder.launches)
    for block in model.layers:
        block.attn.attention = reference_attention
    want_loss = model(ids, labels=ids)
    want = torch.autograd.grad(want_loss, params)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-3)
    for (name, _), g, w in zip(model.named_parameters(), grads, want):
        assert tolerance.row_rel_err(g, w, floor=1e-3) <= 3e-2, name


@pytest.mark.gpu
def test_cuda_llama_generate_matches_reforwards(cuda_device):
    """llama_generate on the card (bf16, GQA) gives the argmax of a
    full fp32 re-forward through ``reference_attention``, within the
    3-bf16-unit rule of chip_smoke's serve phases."""
    cfg = tllama.llama_tiny(hidden_size=512, intermediate_size=1024,
                            n_heads=4, dtype=torch.bfloat16)
    model = tllama.LlamaForCausalLM(cfg, device=cuda_device)
    model.reset_parameters(torch.Generator(cuda_device).manual_seed(0))
    prompt = torch.from_numpy(_ids(2, seed=3, seq=12)).to(cuda_device)
    out = tllama.llama_generate(model, prompt, 8)
    oracle = tllama.LlamaForCausalLM(
        dataclasses.replace(cfg, dtype=torch.float32, use_flash=False),
        device=cuda_device)
    oracle.load_state_dict({k: v.float() for k, v in
                            model.state_dict().items()})
    with torch.no_grad():
        rows = oracle(out[:, :-1])[:, 11:].float()
    tok = out[:, 12:].long()
    top = rows.max(-1).values
    gap = top - rows.gather(-1, tok[..., None])[..., 0]
    ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30))) - 7)
    assert float((gap / ulp).max()) <= 3
