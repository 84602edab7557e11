"""deepspeed_tpu_torch paged GPT-2 serving vs the JAX serving engine.

The same weights (the JAX training tree, carried across by
``from_jax_params``) and the same requests go through both engines on
the CPU; the JAX decode tick runs its Pallas kernels in interpret mode,
the port runs its kernels' plain versions at fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.serving as jserving
import deepspeed_tpu_torch.serving as serving
from deepspeed_tpu_torch.config.config import (DeepSpeedConfigError,
                                               ServingConfig)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, init_params
from deepspeed_tpu_torch.models.gpt2_inference import (dense_logits,
                                                       from_jax_params)
from deepspeed_tpu_torch.serving.paged_cache import (PagedCacheSpec,
                                                     PagedKVCache,
                                                     TRASH_BLOCK,
                                                     padded_prefill_inputs)

SERVING = {"slots": 2, "page_size": 16, "max_pages_per_slot": 6}
LENS = (5, 21, 11, 3, 17)
NEWS = (9, 2, 6, 11, 4)


def _cfgs():
    """The tests/test_serving.py geometry, in both packages."""
    from deepspeed_tpu.models.gpt2 import GPT2Config as JCfg
    kw = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
              n_head=4)
    return (JCfg(dtype=jnp.float32, param_dtype=jnp.float32,
                 scan_layers=True, **kw),
            GPT2Config(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def jax_run():
    """One JAX engine run shared by the module: (jcfg, cfg, params,
    engine, prompts, results)."""
    from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel
    jcfg, cfg = _cfgs()
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        GPT2LMHeadModel(jcfg).init)(jax.random.PRNGKey(0),
                                    np.zeros((1, 8), np.int32))["params"])
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, size=(s,)).astype(np.int32) for s in LENS]
    eng = jserving.build_engine("gpt2", jcfg, params,
                                config={"serving": SERVING})
    res = eng.serve([jserving.Request(i, p, max_new_tokens=n)
                     for i, (p, n) in enumerate(zip(prompts, NEWS))])
    return jcfg, cfg, params, eng, prompts, res


def _port_engine(cfg, params, **kw):
    return serving.build_engine("gpt2", cfg, params,
                                config={"serving": {**SERVING, **kw}},
                                device="cpu")


# ------------------------------------------------------------ weight bridge

def test_weight_bridge_layouts_agree(jax_run):
    """Scan-stacked, unrolled and converted-inference JAX trees carry
    across to the same stacked tensors."""
    from deepspeed_tpu.models.gpt2_inference import convert_gpt2_params
    jcfg, cfg, params, *_ = jax_run
    stacked = from_jax_params(params, cfg, "cpu")
    unrolled = {k: v for k, v in params.items() if k != "h"}
    for i in range(cfg.n_layer):
        unrolled[f"h_{i}"] = jax.tree_util.tree_map(
            lambda a: a[i], params["h"]["blk"])
    converted = jax.tree_util.tree_map(
        np.asarray, convert_gpt2_params(params, jcfg))
    for other in (from_jax_params(unrolled, cfg, "cpu"),
                  from_jax_params(converted, cfg, "cpu")):
        assert other.keys() == stacked.keys()
        for k in stacked:
            assert torch.equal(other[k], stacked[k]), k
    np.testing.assert_array_equal(
        stacked["attn_qkvw"][1].numpy(),
        params["h"]["blk"]["attn"]["c_attn"]["kernel"][1])


# ------------------------------------------------------ allocator + config

def test_page_allocator_accounting():
    spec = PagedCacheSpec(n_layers=1, kv_heads=1, head_dim=8,
                          page_size=4, slots=2, max_pages_per_slot=4,
                          num_blocks=6)       # undersubscribed pool
    cache = PagedKVCache(spec, "cpu")
    total = cache.free_pages
    assert total == spec.resolved_num_blocks() - 1   # trash reserved
    pages = cache.admit(0, total_tokens=9)           # 3 pages of 4
    assert len(pages) == 3 and TRASH_BLOCK not in pages
    assert cache.free_pages == total - 3
    assert list(cache.page_table[0][:3]) == pages
    assert cache.free_pages == 2
    assert cache.admit(1, total_tokens=9) is None    # pool exhausted
    assert cache.free_pages == 2                     # nothing leaked
    cache.release(0)
    assert cache.free_pages == total
    assert all(cache.page_table[0] == TRASH_BLOCK)
    # LIFO: the pages just freed are the next ones handed out
    assert sorted(cache.admit(1, total_tokens=9)) == sorted(pages)
    assert tuple(cache.pool[0].shape) == (1, 6, 1, 4, 8)


def test_serving_config_block_validation():
    sc = ServingConfig({"serving": {"slots": 4, "page_size": 64}})
    assert sc.enabled and sc.slots == 4 and sc.page_size == 64
    assert not ServingConfig({}).enabled
    for bad in ({"kv_cache_bits": 4}, {"slots": 0},
                {"slots": 8, "num_blocks": 4}, {"quantize_bits": 3}):
        with pytest.raises(DeepSpeedConfigError):
            ServingConfig({"serving": bad})
    # the same messages as the JAX block
    from deepspeed_tpu.config.config import ServingConfig as JServingConfig
    from deepspeed_tpu.config.config import DeepSpeedConfigError as JErr
    for bad in ({"slots": 0}, {"slots": 8, "num_blocks": 4},
                {"kv_cache_bits": 4}):
        with pytest.raises(JErr) as want:
            JServingConfig({"serving": bad})
        with pytest.raises(DeepSpeedConfigError) as got:
            ServingConfig({"serving": bad})
        assert str(got.value) == str(want.value)
    # what is not ported raises instead of being dropped
    for sub in ("prefix_cache", "speculative", "elastic", "autoscale",
                "disaggregation", "router"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingConfig({"serving": {sub: {}}})
    ServingConfig({"serving": {"prefix_cache": {"enabled": False}}})
    # int8 serving: the block takes it, and a GPT-2 engine built with it
    # holds int8 codes (quantize_bits) or an int8 pool (kv_cache_bits)
    _, cfg = _cfgs()
    params = init_params(cfg, seed=0, device="cpu")
    for bits in ("kv_cache_bits", "quantize_bits"):
        assert getattr(ServingConfig({"serving": {bits: 8}}), bits) == 8
        eng = _port_engine(cfg, params, **{bits: 8})
        assert (eng.adapter.p["attn_qkvw"].dtype == torch.int8) == (
            bits == "quantize_bits")
        assert len(eng.cache.pool) == (4 if bits == "kv_cache_bits" else 2)


def test_build_engine_defaults_to_cuda():
    """device=None means the card; without one it raises and names the
    CPU opt-in instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None builds on it")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        serving.build_engine("gpt2", cfg, {}, config={"serving": SERVING})
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        init_params(cfg, seed=0)
    # GPT-2's int8 trees carry across, all four layer matrices quantized
    # or none: a half-quantized tree is refused
    blk = {name: {"kernel": np.zeros(1, np.float32)}
           for name in ("attn_qkvw", "attn_ow", "inter_w", "output_w")}
    blk["attn_qkvw"] = {"kernel_q": np.zeros(1, np.int8)}
    int8_tree = {"wte": np.zeros((256, 128), np.float32),
                 "h": {"blk": blk}}
    with pytest.raises(ValueError, match="all four layer matrices"):
        serving.build_engine("gpt2", cfg, int8_tree, device="cpu")


# --------------------------------------------------------------- end to end

def test_greedy_tokens_match_jax_engine(jax_run):
    """5 requests through 2 slots (slot and page reuse): tokens identical
    to the JAX engine's, and the same prefill/decode accounting."""
    _, cfg, params, jeng, prompts, jres = jax_run
    eng = _port_engine(cfg, params)
    res = eng.serve([serving.Request(i, p, max_new_tokens=n)
                     for i, (p, n) in enumerate(zip(prompts, NEWS))])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(res[i].tokens(), jres[i].tokens())
        assert res[i].finish_reason == jres[i].finish_reason == "length"
    for key in ("prefills", "decode_tokens", "prefill_tokens"):
        assert eng.stats[key] == jeng.stats[key], key
    snap = eng.metrics_snapshot()
    assert snap["ttft_s"]["count"] == len(prompts)
    assert 0 < snap["page_pool"]["occupancy_hwm"] <= 1
    assert snap["page_pool"]["used_pages"] == 0      # everything freed
    # the last tick's logits, over the same final slot state
    assert_last = np.asarray(jeng.last_logits)
    np.testing.assert_allclose(eng.last_logits.numpy(), assert_last,
                               atol=1e-4, rtol=1e-4)


def test_prefill_logits_and_pages_match_jax(jax_run):
    jcfg, cfg, params, jeng, prompts, _ = jax_run
    eng = _port_engine(cfg, params)
    P = SERVING["page_size"]
    prompt = prompts[1]
    S = len(prompt)
    pages = [4, 2]            # scattered; the bucket pads the rest to trash
    ids, page_vec = padded_prefill_inputs(prompt, pages, P, 128 // P)
    jcache = jeng.adapter.make_cache()
    jpool, jlogits = jeng.adapter.prefill(
        jcache.pool, jnp.asarray(ids), jnp.asarray(S, jnp.int32),
        jnp.asarray(page_vec))
    pool, logits = eng.adapter.prefill(eng.cache.pool, ids, S, page_vec)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    for mine, theirs in zip(pool, jpool):
        np.testing.assert_allclose(mine[:, pages].numpy(),
                                   np.asarray(theirs)[:, pages],
                                   atol=1e-4, rtol=1e-4)
    # and against the dense full-sequence oracle
    np.testing.assert_allclose(
        logits.numpy(), dense_logits(eng.adapter.p, cfg, prompt)[-1].numpy(),
        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("int8", [False, True])
def test_tick_appends_into_the_pool_as_jax_does(jax_run, int8):
    """One decode tick after a prefill, slot 0 live and slot 1 idle (its
    table all trash): the attention call appends slot 0's new K/V rows
    (int8 codes and scales into an int8 pool) where the JAX tick's
    ``_append_rows`` puts them, so the pools agree on every block but the
    trash block at the prefill test's 1e-4, as do the logits; the idle
    slot writes nothing (JAX writes its row into the trash block, whose
    contents no test reads), so the port's trash block is as the prefill
    left it."""
    jcfg, cfg, params, _, prompts, _ = jax_run
    kw = {"kv_cache_bits": 8, "quantize_bits": 8} if int8 else {}
    jeng = jserving.build_engine("gpt2", jcfg, params,
                                 config={"serving": {**SERVING, **kw}})
    eng = _port_engine(cfg, params, **kw)
    P = SERVING["page_size"]
    prompt = prompts[1]
    S = len(prompt)
    pages = [4, 2]
    ids, page_vec = padded_prefill_inputs(prompt, pages, P, 128 // P)
    jpool, jlogits = jeng.adapter.prefill(
        jeng.adapter.make_cache().pool, jnp.asarray(ids),
        jnp.asarray(S, jnp.int32), jnp.asarray(page_vec))
    pool, _ = eng.adapter.prefill(eng.cache.pool, ids, S, page_vec)
    before = [t.clone() for t in pool]
    maxp = SERVING["max_pages_per_slot"]
    pt = np.full((2, maxp), TRASH_BLOCK, np.int32)
    pt[0, :2] = pages
    tok = np.array([int(np.argmax(np.asarray(jlogits))), 0], np.int32)
    pos = np.array([S, -1], np.int32)
    zeros = np.zeros(2, np.int32)
    jpool, jtoks, jl = jeng.adapter.tick(
        jpool, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(pt),
        jnp.asarray(zeros), jnp.asarray(zeros), jnp.zeros(2, jnp.float32))
    pool, toks, logits = eng.adapter.tick(
        pool, tok, pos, pt, zeros, zeros, np.zeros(2, np.float32))
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(jl)[0],
                               atol=1e-4, rtol=1e-4)
    assert int(toks[0, 0]) == int(np.asarray(jtoks)[0, 0])
    keep = [b for b in range(pool[0].shape[1]) if b != TRASH_BLOCK]
    for mine, theirs, old in zip(pool, jpool, before):
        theirs = np.asarray(theirs)
        if mine.dtype == torch.int8:
            diff = np.abs(mine[:, keep].numpy().astype(np.int32)
                          - theirs[:, keep].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            np.testing.assert_allclose(mine[:, keep].numpy(),
                                       theirs[:, keep], atol=1e-4,
                                       rtol=1e-4)
        assert torch.equal(mine[:, TRASH_BLOCK], old[:, TRASH_BLOCK])
    # the new row is the tick's: row S % P of page pt[0, S // P] changed
    assert not torch.equal(pool[0][:, pages[S // P], :, S % P],
                           before[0][:, pages[S // P], :, S % P])


def test_eos_frees_slot_early(jax_run):
    _, cfg, params, *_ = jax_run
    p = np.random.RandomState(7).randint(0, 256, size=(9,)).astype(np.int32)

    def run(eos):
        eng = _port_engine(cfg, params)
        return eng, eng.serve([serving.Request(
            "r", p, max_new_tokens=12, eos_token_id=eos)])["r"]

    _, full = run(None)
    assert full.finish_reason == "length" and len(full.generated) == 12
    eos_tok = int(full.generated[3])
    first = full.generated.index(eos_tok)
    eng, stopped = run(eos_tok)
    assert stopped.finish_reason == "eos"
    assert stopped.generated == full.generated[:first + 1]
    assert eng.cache.free_pages == eng.cache.num_blocks - 1


def test_sampled_requests_are_seeded_per_request(jax_run):
    """Temperature sampling draws from a generator seeded by (sample_key,
    token index): a rerun of the same request reproduces its stream, even
    when another request shares the ticks."""
    _, cfg, params, _, prompts, _ = jax_run

    def run(with_other):
        eng = _port_engine(cfg, params)
        reqs = [serving.Request("s", prompts[0], max_new_tokens=8,
                                temperature=1.0, sample_key=1234)]
        if with_other:
            reqs.append(serving.Request("g", prompts[2], max_new_tokens=5))
        return eng.serve(reqs)["s"].generated

    assert run(False) == run(True)
