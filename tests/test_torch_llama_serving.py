"""deepspeed_tpu_torch paged LLaMA serving vs the JAX serving engine.

The same packed fp32 weights (the JAX ``convert_llama_serving_params`` of
a flax ``LlamaForCausalLM`` tree, carried across by the port's bridge)
and the same requests go through both engines on the CPU, at the
``tests/test_serving.py`` LLaMA geometry (GQA: 4 heads, 2 KV heads). The
JAX tick runs its Pallas kernels in interpret mode; the port runs its
kernels' plain versions at fp32, on both branches of the o-projection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.serving as jserving
import deepspeed_tpu_torch.serving as serving
from deepspeed_tpu_torch.models import llama_inference
from deepspeed_tpu_torch.models.llama import (LlamaConfig, rope_rows,
                                              rope_tables)
from deepspeed_tpu_torch.serving.paged_cache import padded_prefill_inputs
from torch_port_common import assert_close, t32

SERVING = {"slots": 2, "page_size": 16, "max_pages_per_slot": 6}
LENS = (5, 21, 11, 3, 17)
NEWS = (9, 2, 6, 11, 4)
GEOM = dict(vocab_size=256, hidden_size=128, n_layers=2, n_heads=4,
            n_kv_heads=2, intermediate_size=256, max_seq_len=128)


def _cfgs():
    from deepspeed_tpu.models.llama import LlamaConfig as JCfg
    return (JCfg(dtype=jnp.float32, param_dtype=jnp.float32, **GEOM),
            LlamaConfig(dtype=torch.float32, **GEOM))


@pytest.fixture(scope="module")
def jax_run():
    """One JAX engine run shared by the module: (jcfg, cfg, training
    tree, packed tree, engine, prompts, results)."""
    from deepspeed_tpu.models.llama import LlamaForCausalLM
    from deepspeed_tpu.models.llama_inference import \
        convert_llama_serving_params
    jcfg, cfg = _cfgs()
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        LlamaForCausalLM(jcfg).init)(jax.random.PRNGKey(0),
                                     np.zeros((1, 8), np.int32))["params"])
    packed = jax.tree_util.tree_map(
        np.asarray, convert_llama_serving_params(params, jcfg))
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, size=(s,)).astype(np.int32) for s in LENS]
    eng = jserving.build_engine("llama", jcfg, packed,
                                config={"serving": SERVING})
    res = eng.serve([jserving.Request(i, p, max_new_tokens=n)
                     for i, (p, n) in enumerate(zip(prompts, NEWS))])
    return jcfg, cfg, params, packed, eng, prompts, res


def _port_engine(cfg, params):
    return serving.build_engine("llama", cfg, params,
                                config={"serving": SERVING}, device="cpu")


def test_llama_weight_bridge(jax_run):
    """The training tree and the packed tree carry across to the same
    tensors; the port's packing equals JAX's; an int8 tree carries across
    as int8 codes and scales, never dequantized."""
    from deepspeed_tpu.models.llama_inference import \
        quantize_llama_serving_params
    jcfg, cfg, params, packed, *_ = jax_run
    mine = llama_inference.convert_llama_serving_params(params, cfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, mine, packed)
    a = llama_inference.from_jax_serving_params(params, cfg, "cpu")
    b = llama_inference.from_jax_serving_params(packed, cfg, "cpu")
    assert a.keys() == b.keys() == set(llama_inference.param_shapes(cfg))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    np.testing.assert_array_equal(
        a["qkv_w"][1, :, 128:192].numpy(),
        params["layers"]["blk"]["attn"]["k_proj"]["kernel"][1])
    q8 = jax.tree_util.tree_map(np.asarray,
                                quantize_llama_serving_params(packed))
    c = llama_inference.from_jax_serving_params(q8, cfg, "cpu")
    assert c["qkv_w"].dtype == torch.int8 and torch.equal(
        c["qkv_w"], torch.tensor(q8["blk"]["qkv_w"]["kernel_q"]))
    assert torch.equal(c["o_w_scale"],
                       torch.tensor(q8["blk"]["o_w"]["kernel_scale"]))
    q8["blk"]["up_w"] = packed["blk"]["up_w"]        # a mixed tree
    with pytest.raises(ValueError, match="all five"):
        llama_inference.from_jax_serving_params(q8, cfg, "cpu")


def test_llama_cache_spec_and_seeded_weights():
    _, cfg = _cfgs()
    spec = serving.cache_spec_from_config(cfg, "llama",
                                          {"serving": SERVING})
    assert (spec.n_layers, spec.kv_heads, spec.head_dim) == (2, 2, 32)
    p0 = llama_inference.init_serving_params(cfg, seed=3, device="cpu")
    p1 = llama_inference.init_serving_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert p0["qkv_w"].shape == (2, 128, 256)
    assert abs(float(p0["gate_w"].std()) - 0.02) < 2e-3
    assert torch.equal(p0["norm1"], torch.ones(2, 128))


@pytest.mark.parametrize("branch", ["fused", "matvec"])
def test_llama_greedy_tokens_match_jax_engine(jax_run, monkeypatch,
                                              branch):
    """5 requests through 2 slots: tokens identical to the JAX engine's
    and the last tick's logits at fp32 2e-5. ``matvec`` forces the
    large-E branch (matvec_stacked, then out_ffn with fuse_proj=False)
    at this width, where JAX takes the fused one."""
    _, cfg, _, packed, jeng, prompts, jres = jax_run
    if branch == "matvec":
        monkeypatch.setattr(llama_inference, "FUSED_PROJ_MAX_BYTES", 0)
    eng = _port_engine(cfg, packed)
    assert eng.adapter.fused_proj() == (branch == "fused")
    res = eng.serve([serving.Request(i, p, max_new_tokens=n)
                     for i, (p, n) in enumerate(zip(prompts, NEWS))])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(res[i].tokens(), jres[i].tokens())
    for key in ("prefills", "decode_tokens", "prefill_tokens"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.metrics_snapshot()["page_pool"]["used_pages"] == 0
    assert_close(eng.last_logits, np.asarray(jeng.last_logits))


def test_llama_prefill_logits_and_pages_match_jax(jax_run):
    _, cfg, _, packed, jeng, prompts, _ = jax_run
    eng = _port_engine(cfg, packed)
    P = SERVING["page_size"]
    prompt = prompts[1]
    S = len(prompt)
    pages = [4, 2]
    ids, page_vec = padded_prefill_inputs(prompt, pages, P, 128 // P)
    jcache = jeng.adapter.make_cache()
    jpool, jlogits = jeng.adapter.prefill(
        jcache.pool, jnp.asarray(ids), jnp.asarray(S, jnp.int32),
        jnp.asarray(page_vec))
    pool, logits = eng.adapter.prefill(eng.cache.pool, ids, S, page_vec)
    assert_close(logits, np.asarray(jlogits))
    for mine, theirs in zip(pool, jpool):
        assert_close(mine[:, pages], np.asarray(theirs)[:, pages])
    # and against the dense full-sequence oracle, also computed in fp32
    # from bf16 weights (the matrices cast layer by layer)
    dense = llama_inference.dense_logits(eng.adapter.p, cfg, prompt)
    assert_close(logits, dense[-1])
    bf = {k: v.to(torch.bfloat16) if v.dim() == 3 else v
          for k, v in eng.adapter.p.items()}
    up = {k: v.float() for k, v in bf.items()}
    assert torch.equal(llama_inference.dense_logits(bf, cfg, prompt,
                                                    torch.float32),
                       llama_inference.dense_logits(up, cfg, prompt))


def test_rope_rows_match_jax():
    """The tick's RoPE (tables made once a step, q and k rotated in one
    call) against JAX's ``_rope_rows`` at per-slot positions, idle slot
    included; in bf16 it rounds where JAX's formula does, bit for bit."""
    from deepspeed_tpu.serving.adapters import _rope_rows as jrope
    rs = np.random.RandomState(5)
    x = rs.randn(5, 6, 128).astype(np.float32)
    pos = np.array([0, 7, 300, 1999, -1], np.int32)
    got = rope_rows(t32(x), *rope_tables(
        torch.from_numpy(pos), 128, 10000.0, torch.float32))
    assert_close(got, np.asarray(jrope(jnp.asarray(x), jnp.asarray(pos),
                                       10000.0)))
    xb = t32(x).to(torch.bfloat16)
    inv = 1.0 / (10000.0 ** (torch.arange(0, 128, 2).float() / 128))
    ang = torch.from_numpy(pos).float()[:, None, None] * inv
    c, s = torch.cos(ang).to(xb.dtype), torch.sin(ang).to(xb.dtype)
    x1, x2 = xb[..., :64], xb[..., 64:]
    want = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)
    assert torch.equal(rope_rows(xb, *rope_tables(
        torch.from_numpy(pos), 128, 10000.0, torch.bfloat16)), want)
