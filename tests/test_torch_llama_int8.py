"""deepspeed_tpu_torch int8 LLaMA serving (int8 weight codes, the int8 KV
cache) vs the JAX package.

On the CPU, at fp32 and the ``tests/test_serving.py`` LLaMA geometry
(GQA: 4 heads, 2 KV heads of 32): the new plain versions against their
Pallas functions in interpret mode (``kv_quant_int8`` bit for bit, the
int8 paged and the int8 and fp stacked attention at 2e-5, the weight
kernels on int8 codes), ``quantize_serving_params`` bit for bit against
``quantize_llama_serving_params``, the paged int8 engine's tokens against
the JAX engine's on both o-projection branches, ``llama_fast_generate``'s
tokens against JAX's at kv 0 and kv 8 with fp and int8 weights, and the
paged int8 engine against the port's ``llama_fast_generate``. On the card
(``gpu`` marker) each CUDA kernel against its plain version.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch.serving as serving
from deepspeed_tpu_torch.models import llama_inference
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops.cuda import builder, decode, tolerance
from deepspeed_tpu_torch.ops.cuda.decode import (
    decode_attention_paged, decode_attention_paged_plain,
    decode_attention_stacked, decode_attention_stacked_plain, kv_quant_int8,
    kv_quant_int8_plain, ln_qkv_stacked, ln_qkv_stacked_plain,
    matvec_stacked, matvec_stacked_plain, out_ffn_stacked,
    out_ffn_stacked_plain)
from torch_port_common import assert_close, cuda_device, t32  # noqa: F401

GEOM = dict(vocab_size=256, hidden_size=128, n_layers=2, n_heads=4,
            n_kv_heads=2, intermediate_size=256, max_seq_len=128)
SERVING = {"slots": 2, "page_size": 16, "max_pages_per_slot": 6}
INT8 = {"quantize_bits": 8, "kv_cache_bits": 8}
LENS, NEWS = (21, 9, 5), (6, 10, 4)
LAYER = 1


def _jax():
    """(jax, jax.numpy, the Pallas decode module), imported here so the
    gpu tests also run where JAX is not installed."""
    return (importlib.import_module("jax"),
            importlib.import_module("jax.numpy"),
            importlib.import_module("deepspeed_tpu.ops.pallas.decode"))


def _cfgs():
    _, jnp, _ = _jax()
    from deepspeed_tpu.models.llama import LlamaConfig as JCfg
    return (JCfg(dtype=jnp.float32, param_dtype=jnp.float32, **GEOM),
            LlamaConfig(dtype=torch.float32, **GEOM))


def _np_tree(tree):
    jax, _, _ = _jax()
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """(jcfg, cfg, packed fp tree, JAX-quantized tree, random int8 tree,
    prompts), as numpy."""
    jax, _, _ = _jax()
    from deepspeed_tpu.models.llama import LlamaForCausalLM
    from deepspeed_tpu.models.llama_inference import (
        convert_llama_serving_params, quantize_llama_serving_params,
        random_int8_serving_params)
    jcfg, cfg = _cfgs()
    params = jax.jit(LlamaForCausalLM(jcfg).init)(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"]
    packed = _np_tree(convert_llama_serving_params(params, jcfg))
    q8 = _np_tree(quantize_llama_serving_params(packed))
    r8 = _np_tree(random_int8_serving_params(jcfg))
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, size=(s,)).astype(np.int32) for s in LENS]
    return jcfg, cfg, packed, q8, r8, prompts


def _requests(mod, prompts):
    return [mod.Request(i, p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, NEWS))]


def _codes(rs, *shape):
    return rs.randint(-127, 128, size=shape).astype(np.int8)


def _scales(rs, *shape):
    return (0.5 + rs.rand(*shape)).astype(np.float32)


# ------------------------------------------------ plain versions vs JAX

def test_kv_quant_plain_bit_equal_to_pallas():
    """Codes and scales equal the Pallas kernel's bit for bit, on fp32
    and bf16 rows, with exact halves (round half to even) planted."""
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(0)
    k = rs.randn(3, 4, 128).astype(np.float32)
    v = (3 * rs.randn(3, 4, 128)).astype(np.float32)
    k[0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]      # scale 1: halves
    v[1, 2] = 0.0                                         # scale 1e-12
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = jdec.kv_quant_int8(jnp.asarray(k, jdt), jnp.asarray(v, jdt))
        got = kv_quant_int8(t32(k).to(dt), t32(v).to(dt))
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.dtype == {np.int8: torch.int8,
                               np.float32: torch.float32}[w.dtype.type]
            np.testing.assert_array_equal(g.numpy(), w)
    assert got[0][0, 0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_kv_quant_writes_into_paged_pool_and_stacked_cache():
    """The destination forms write what the JAX scatters write: the paged
    pool at (blk[b], rows[b]) (``serving/adapters.py:35-51``) and the
    stacked cache at one position (``models/llama_inference.py:293-301``);
    nothing else changes."""
    _, jnp, _ = _jax()
    from deepspeed_tpu.serving.adapters import _append_rows
    rs = np.random.RandomState(1)
    k3, v3 = rs.randn(3, 2, 32).astype(np.float32), \
        rs.randn(3, 2, 32).astype(np.float32)
    pool = (_codes(rs, 2, 7, 2, 16, 32), _scales(rs, 2, 7, 2, 1, 16),
            _codes(rs, 2, 7, 2, 16, 32), _scales(rs, 2, 7, 2, 1, 16))
    blk, rows = np.array([5, 0, 3], np.int32), np.array([2, 9, 15], np.int32)
    want = _append_rows(tuple(map(jnp.asarray, pool)), True, LAYER,
                        jnp.asarray(blk), jnp.asarray(rows),
                        jnp.asarray(k3), jnp.asarray(v3))
    got = tuple(torch.from_numpy(a.copy()) for a in pool)
    kv_quant_int8(t32(k3), t32(v3), out=got, layer=LAYER,
                  blocks=torch.from_numpy(blk), rows=torch.from_numpy(rows))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cache = (np.zeros((2, 3, 2, 48, 32), np.int8),
             np.zeros((2, 3, 2, 1, 48), np.float32),
             np.zeros((2, 3, 2, 48, 32), np.int8),
             np.zeros((2, 3, 2, 1, 48), np.float32))
    got = tuple(torch.from_numpy(a) for a in cache)
    kv_quant_int8(t32(k3), t32(v3), out=got, layer=LAYER,
                  rows=torch.tensor([17], dtype=torch.int32))
    kq, ks, vq, vs = kv_quant_int8_plain(t32(k3), t32(v3))
    assert torch.equal(got[0][LAYER, :, :, 17], kq)
    assert torch.equal(got[3][LAYER, :, :, 0, 17], vs[..., 0])
    assert int(torch.count_nonzero(got[2])) == int(torch.count_nonzero(vq))


def _paged_int8(rs, Lyr=2, NB=9, Hkv=2, P=16, D=128, B=3, R=4, MAXP=4):
    pools = (_codes(rs, Lyr, NB, Hkv, P, D), _scales(rs, Lyr, NB, Hkv, 1, P)
             * 0.01, _codes(rs, Lyr, NB, Hkv, P, D),
             _scales(rs, Lyr, NB, Hkv, 1, P) * 0.01)
    q = (0.3 * rs.randn(B, Hkv, R, D)).astype(np.float32)
    pt = np.zeros((B, MAXP), np.int32)           # tails point at trash
    pt[0, :2] = [5, 3]                           # scattered, out of order
    pt[1, :4] = [1, 8, 2, 7]
    pt[2, :1] = [6]
    pos = np.array([20, 58, -1], np.int32)       # slot 2 idle
    return q, pools, pos, pt


@pytest.mark.parametrize("R", [1, 4])
def test_paged_attention_int8_plain_matches_pallas(R):
    """The int8 pool with its [Lyr, NB, H, 1, page] scales, GQA rows, a
    scattered page table and an idle slot."""
    _, jnp, jdec = _jax()
    q, (kc, ks, vc, vs), pos, pt = _paged_int8(np.random.RandomState(2),
                                               R=R)
    want = np.asarray(jdec.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        jnp.asarray(pt), LAYER, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), scale=1.0 / math.sqrt(128)))
    got = decode_attention_paged(
        t32(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pos), torch.from_numpy(pt), LAYER,
        k_scale=t32(ks), v_scale=t32(vs), scale=1.0 / math.sqrt(128))
    assert_close(got, want)
    assert not np.any(want[2])


@pytest.mark.parametrize("int8,R", [(True, 1), (True, 4), (False, 4)])
def test_stacked_attention_plain_matches_pallas(int8, R):
    """decode_attention_int8_stacked / decode_attention_fp_stacked: one
    position for every row, GQA rows, and a tail past pos that holds
    data (it must not be read)."""
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(3)
    Lyr, B, Hkv, L, D = 2, 3, 2, 256, 128
    q = (0.3 * rs.randn(B, Hkv, R, D)).astype(np.float32)
    pos = 137
    if int8:
        kc, vc = _codes(rs, Lyr, B, Hkv, L, D), _codes(rs, Lyr, B, Hkv, L, D)
        ks, vs = (_scales(rs, Lyr, B, Hkv, 1, L) * 0.01 for _ in range(2))
        want = jdec.decode_attention_int8_stacked(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(ks), jnp.asarray(vc),
            jnp.asarray(vs), pos, LAYER)
        got = decode_attention_stacked(
            t32(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.tensor([pos], dtype=torch.int32), LAYER, k_scale=t32(ks),
            v_scale=t32(vs))
    else:
        kc, vc = (rs.randn(Lyr, B, Hkv, L, D).astype(np.float32)
                  for _ in range(2))
        want = jdec.decode_attention_fp_stacked(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), pos, LAYER)
        got = decode_attention_stacked(t32(q), t32(kc), t32(vc), pos, LAYER)
    assert_close(got, np.asarray(want))


def _qkv_int8(rs, B=3, E=128, N=256, L=3):
    return dict(x=rs.randn(B, E).astype(np.float32),
                ln_w=(1 + 0.1 * rs.randn(L, E)).astype(np.float32),
                w=_codes(rs, L, E, N), s=_scales(rs, L) * 1e-3)


def test_ln_qkv_and_matvec_int8_plain_match_pallas():
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(4)
    a = _qkv_int8(rs)
    want = jdec.ln_qkv_int8_stacked(
        jnp.asarray(a["x"]), jnp.asarray(a["ln_w"]), None,
        jnp.asarray(a["w"]), jnp.asarray(a["s"]), None, LAYER, norm="rms")
    got = ln_qkv_stacked(t32(a["x"]), t32(a["ln_w"]), None,
                         torch.from_numpy(a["w"]), t32(a["s"]), None, LAYER,
                         norm="rms")
    assert_close(got, np.asarray(want))
    x, w, s = rs.randn(8, 256).astype(np.float32), _codes(rs, 3, 256, 384), \
        _scales(rs, 3) * 1e-3
    want = jdec.matvec_int8_stacked(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(s), LAYER)
    assert_close(matvec_stacked(t32(x), torch.from_numpy(w), t32(s), LAYER),
                 np.asarray(want))


@pytest.mark.parametrize("fuse_proj", [True, False])
def test_out_ffn_swiglu_int8_plain_matches_pallas(fuse_proj):
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(5)
    E, F, L = 128, 256, 3
    a = dict(ctx=rs.randn(3, E).astype(np.float32),
             x=rs.randn(3, E).astype(np.float32), wp=_codes(rs, L, E, E),
             sp=_scales(rs, L) * 1e-3,
             ln_w=(1 + 0.1 * rs.randn(L, E)).astype(np.float32),
             wg=_codes(rs, L, E, F), sg=_scales(rs, L) * 1e-3,
             wu=_codes(rs, L, E, F), su=_scales(rs, L) * 1e-3,
             wd=_codes(rs, L, F, E), sd=_scales(rs, L) * 1e-3)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    want = jdec.out_ffn_int8_stacked(
        j["ctx"] if fuse_proj else None, j["x"],
        j["wp"] if fuse_proj else None, j["sp"] if fuse_proj else None,
        None, j["ln_w"], None, j["wg"], j["sg"], None, j["wd"], j["sd"],
        None, LAYER, act="swiglu", norm="rms", w1b_stack=j["wu"],
        s1b=j["su"], fuse_proj=fuse_proj)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = out_ffn_stacked(
        t["ctx"], t["x"], t["wp"], t["sp"], None, t["ln_w"], None, t["wg"],
        t["sg"], None, t["wd"], t["sd"], None, LAYER, act="swiglu",
        norm="rms", w1b_stack=t["wu"], s1b=t["su"], fuse_proj=fuse_proj)
    assert_close(got, np.asarray(want))


# --------------------------------------------------- weights and bridge

def test_quantize_and_random_int8_weights_bit_equal_to_jax(trees):
    """quantize_serving_params equals quantize_llama_serving_params bit
    for bit (codes and scales), and random_int8_serving_params draws
    JAX's tree; both carry across the bridge unchanged."""
    _, cfg, packed, q8, r8, _ = trees
    mine = llama_inference.quantize_serving_params(
        llama_inference.from_jax_serving_params(packed, cfg, "cpu"))
    theirs = llama_inference.from_jax_serving_params(q8, cfg, "cpu")
    rnd = llama_inference.random_int8_serving_params(cfg, seed=0,
                                                     device="cpu")
    want = llama_inference.from_jax_serving_params(r8, cfg, "cpu")
    for got, ref in ((mine, theirs), (rnd, want)):
        assert got.keys() == ref.keys() == set(
            llama_inference.param_shapes(cfg, int8=True))
        for k in ref:
            assert got[k].dtype == ref[k].dtype and torch.equal(
                got[k], ref[k]), k
    assert mine["qkv_w"].dtype == torch.int8
    assert mine["down_w_scale"].shape == (2,)


# ---------------------------------------------------------- end to end

@pytest.fixture(scope="module")
def jax_int8_run(trees):
    """The JAX engine with quantize_bits 8 and kv_cache_bits 8 over the
    fp packed tree: (engine, results)."""
    import deepspeed_tpu.serving as jserving
    jcfg, _, packed, _, _, prompts = trees
    eng = jserving.build_engine("llama", jcfg, packed,
                                config={"serving": {**SERVING, **INT8}})
    return eng, eng.serve(_requests(jserving, prompts))


@pytest.mark.parametrize("branch", ["fused", "matvec"])
def test_paged_int8_engine_matches_jax_engine(trees, jax_int8_run,
                                              monkeypatch, branch):
    """int8 weights quantized at build and the int8 pool: tokens equal to
    the JAX engine's, on both o-projection branches, and the last tick's
    logits at 2e-5."""
    _, cfg, packed, _, _, prompts = trees
    jeng, jres = jax_int8_run
    if branch == "matvec":
        monkeypatch.setattr(llama_inference, "FUSED_PROJ_MAX_BYTES", 0)
    eng = serving.build_engine("llama", cfg, packed,
                               config={"serving": {**SERVING, **INT8}},
                               device="cpu")
    assert eng.adapter.fused_proj() == (branch == "fused")
    assert eng.adapter.p["gate_w"].dtype == torch.int8
    assert [t.dtype for t in eng.cache.pool] == [
        torch.int8, torch.float32, torch.int8, torch.float32]
    res = eng.serve(_requests(serving, prompts))
    for i in range(len(prompts)):
        np.testing.assert_array_equal(res[i].tokens(), jres[i].tokens())
    assert eng.stats["decode_tokens"] == jeng.stats["decode_tokens"]
    assert_close(eng.last_logits, np.asarray(jeng.last_logits))


def test_paged_int8_engine_follows_the_int8_oracle(trees):
    """Teacher-forced: at every generated position the int8 engine's token
    is the argmax of dense_logits' int8 oracle (fp32 dequantized weights,
    K/V rounded through the cache's codes past the prompt); without the
    rounding the oracle's logits part from the engine's by far more."""
    _, cfg, packed, _, _, prompts = trees
    eng = serving.build_engine("llama", cfg, packed,
                               config={"serving": {**SERVING, **INT8}},
                               device="cpu")
    res = eng.serve(_requests(serving, prompts))
    p = eng.adapter.p
    for r in res.values():
        toks, S = r.tokens(), len(r.prompt)
        rows = llama_inference.dense_logits(p, cfg, toks[:-1], torch.float32,
                                            kv_quant_from=S)[S - 1:]
        np.testing.assert_array_equal(rows.argmax(-1).numpy(), toks[S:])
    last = llama_inference.dense_logits(p, cfg, toks[:-1], torch.float32,
                                        kv_quant_from=S)[-1]
    plain = llama_inference.dense_logits(p, cfg, toks[:-1], torch.float32)[-1]
    assert float((last - plain).abs().max()) > 1e-4


def _o_proj_branch(monkeypatch, branch):
    """Force the o-projection's branch (``llama_inference.fused_proj``,
    which the paged engine's tick and the fast path's decode loop both
    ask) and count the fast path's matvec_stacked calls: the list this
    returns grows by one each call. At the tiny geometry every weight
    fuses; "matvec" takes LLaMA-7B's branch (matvec_stacked + residual +
    out_ffn_stacked(fuse_proj=False))."""
    if branch == "matvec":
        monkeypatch.setattr(llama_inference, "FUSED_PROJ_MAX_BYTES", 0)
    calls, real = [], llama_inference.matvec_stacked

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(llama_inference, "matvec_stacked", counted)
    return calls


@pytest.fixture(scope="module")
def jax_fast_tokens(trees):
    """JAX's llama_fast_generate tokens for two rows at one position, by
    (weights, kv_bits), each run once for both branches' cases."""
    from deepspeed_tpu.models.llama_inference import \
        llama_fast_generate as jgen
    jcfg, _, packed, q8, _, prompts = trees
    ids = np.stack([prompts[0][:9], prompts[1]])
    memo = {}

    def get(weights, kv_bits):
        if (weights, kv_bits) not in memo:
            memo[weights, kv_bits] = np.asarray(jgen(
                jcfg, packed if weights == "fp" else q8, ids,
                max_new_tokens=7, max_out_tokens=128, kv_cache_bits=kv_bits))
        return ids, memo[weights, kv_bits]
    return get


@pytest.mark.parametrize("branch", ["fused", "matvec"])
@pytest.mark.parametrize("weights,kv_bits", [("fp", 0), ("fp", 8),
                                             ("int8", 0), ("int8", 8)])
def test_fast_generate_matches_jax(trees, jax_fast_tokens, monkeypatch,
                                   weights, kv_bits, branch):
    """llama_fast_generate's greedy tokens equal JAX's, fp and int8
    weights, kv 0 (decode_attention_fp_stacked) and kv 8 (kv_quant_int8 +
    decode_attention_int8_stacked), two rows at one position, on both
    o-projection branches (JAX's fused branch at this size is the same
    arithmetic)."""
    _, cfg, packed, q8, _, _ = trees
    calls = _o_proj_branch(monkeypatch, branch)
    ids, want = jax_fast_tokens(weights, kv_bits)
    got = llama_inference.llama_fast_generate(
        cfg, packed if weights == "fp" else q8, ids, max_new_tokens=7,
        max_out_tokens=128, kv_cache_bits=kv_bits, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    # 6 decode steps x 2 layers through matvec_stacked, or none
    assert len(calls) == (12 if branch == "matvec" else 0)


@pytest.mark.parametrize("branch", ["fused", "matvec"])
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_paged_engine_matches_fast_generate(trees, monkeypatch, kv_bits,
                                            branch):
    """The JAX package's own contract (tests/test_serving.py:379-399), in
    the port: random int8 weights, the paged engine's tokens equal
    llama_fast_generate's request by request, both on either o-projection
    branch."""
    _, cfg, _, _, _, prompts = trees
    calls = _o_proj_branch(monkeypatch, branch)
    p = llama_inference.random_int8_serving_params(cfg, seed=0, device="cpu")
    eng = serving.build_engine(
        "llama", cfg, p, config={"serving": {**SERVING,
                                             "kv_cache_bits": kv_bits}},
        device="cpu")
    assert eng.adapter.fused_proj() == (branch == "fused")
    res = eng.serve(_requests(serving, prompts))
    for i, (pr, n) in enumerate(zip(prompts, NEWS)):
        ref = llama_inference.llama_fast_generate(
            cfg, p, pr[None], max_new_tokens=n, max_out_tokens=128,
            kv_cache_bits=kv_bits, device="cpu")[0]
        np.testing.assert_array_equal(res[i].tokens(), ref.numpy())
    assert len(calls) == (sum(n - 1 for n in NEWS) * cfg.n_layers
                          if branch == "matvec" else 0)


def test_fast_generate_sampling_is_deterministic(trees):
    """jax.random's bits cannot be reproduced: a sampled run is held to
    itself under one seed, and another seed draws other tokens."""
    _, cfg, _, q8, _, prompts = trees
    ids = np.stack([prompts[0][:9], prompts[1]])

    def run(seed):
        return llama_inference.llama_fast_generate(
            cfg, q8, ids, max_new_tokens=12, temperature=1.0, rng=seed,
            max_out_tokens=128, kv_cache_bits=8, device="cpu")
    a = run(3)
    assert torch.equal(a, run(3)) and not torch.equal(a, run(4))
    with pytest.raises(AssertionError):
        llama_inference.llama_fast_generate(cfg, q8, ids,
                                            max_new_tokens=200,
                                            max_out_tokens=128,
                                            device="cpu")


# ------------------------------------------------------------ the limits

def _bf(*arrays):
    return [t32(a).to(torch.bfloat16) for a in arrays]


def _int8_cases(key):
    """(plain version on the kernel's inputs, an admissible result, a
    planted fault's result) for one int8 kernel variant at small widths:
    the matvecs summed over a permuted contraction axis, attention in
    fp32 and rounded once; the faults drop weight rows or a page."""
    rs = np.random.RandomState(6)
    if key in ("ln_qkv_stacked[int8]", "matvec_stacked[int8]"):
        x = _bf(rs.randn(4, 512))[0]
        ln_w = t32(1 + 0.1 * rs.randn(2, 512))
        w, s = torch.from_numpy(_codes(rs, 2, 512, 256)), \
            t32(_scales(rs, 2) * 1e-3)
        p = torch.from_numpy(rs.permutation(512))
        wf = w.clone()
        wf[1, -32:] = 0                         # 32 of 512 weight rows

        def run(x, ln_w, w):
            if key == "matvec_stacked[int8]":
                return matvec_stacked_plain(x, w, s, 1)
            return ln_qkv_stacked_plain(x, ln_w, None, w, s, None, 1,
                                        norm="rms")
        return run(x, ln_w, w), run(x[:, p], ln_w[:, p], w[:, p]), \
            run(x, ln_w, wf)
    if key == "out_ffn_stacked[swiglu,int8]":
        x = _bf(rs.randn(4, 256))[0]
        ln_w = t32(1 + 0.1 * rs.randn(2, 256))
        wg, wu = (torch.from_numpy(_codes(rs, 2, 256, 512)) for _ in range(2))
        wd = torch.from_numpy(_codes(rs, 2, 512, 256))
        sg, su, sd = (t32(_scales(rs, 2) * 1e-3) for _ in range(3))
        pf = torch.from_numpy(rs.permutation(512))
        wdf = wd.clone()
        wdf[1, -32:] = 0                        # 32 of 512 rows of Wd

        def run(wg, wu, wd):
            return out_ffn_stacked_plain(
                None, x, None, None, None, ln_w, None, wg, sg, None, wd, sd,
                None, 1, act="swiglu", norm="rms", w1b_stack=wu, s1b=su,
                fuse_proj=False)
        return run(wg, wu, wd), \
            run(wg[..., pf], wu[..., pf], wd[:, pf]), run(wg, wu, wdf)
    q, (kc, ks, vc, vs), pos, pt = _paged_int8(rs, R=4)
    q = _bf(q)[0]
    kc, vc, ks, vs = (torch.from_numpy(a) for a in (kc, vc, ks, vs))
    pos, pt = torch.from_numpy(pos), torch.from_numpy(pt)
    pos_fault = torch.where(pos >= 16, pos // 16 * 16 - 1, pos)

    def run(q, pos):
        return decode_attention_paged_plain(q, kc, vc, pos, pt, 1,
                                            k_scale=ks, v_scale=vs)
    return run(q, pos), run(q.float(), pos).to(torch.bfloat16), \
        run(q, pos_fault)


@pytest.mark.parametrize("key", ["ln_qkv_stacked[int8]",
                                 "matvec_stacked[int8]",
                                 "out_ffn_stacked[swiglu,int8]",
                                 "decode_attention_paged[int8]"])
def test_int8_kernel_limits_admit_rounding_and_reject_a_fault(key):
    want, admissible, fault = _int8_cases(key)
    assert tolerance.check_kernel(key, admissible, want) >= 0
    with pytest.raises(AssertionError, match="row-relative error"):
        tolerance.check_kernel(key, fault, want)


def test_gpt2_contract_refuses_int8_weights_naming_roadmap():
    """int8 codes stream on both contracts, GPT-2's (LayerNorm, biases,
    gelu_tanh) as LLaMA's; with int8 weights as with bf16, GPT-2's
    out_ffn still refuses exact gelu on CUDA, naming ROADMAP."""
    w8 = torch.zeros(1, 8, 8, dtype=torch.int8)
    assert decode._weight_dtype(w8) == torch.int8
    assert decode._weight_dtype(w8.bfloat16()) == torch.bfloat16
    assert decode._out_ffn_contract("t", "gelu_tanh", "layer", True,
                                    None) == "gpt2"
    assert decode._out_ffn_contract("t", "swiglu", "rms", False,
                                    w8) == "llama"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode._out_ffn_contract("t", "gelu", "layer", True, None)


# ------------------------------------------------------------ on the card

def _dev(a, dev, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(a)).to(dev).to(dtype)


def _lid(dev, l=LAYER):
    return torch.tensor(l, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_cuda_kv_quant_bit_equal_to_plain(cuda_device, D):
    """No destination, the paged pool and the stacked cache: codes and
    scales equal to the plain version's bit for bit."""
    dev = cuda_device
    rs = np.random.RandomState(7)
    qkv = _dev(rs.randn(5, 12 * D), dev)         # rows sliced out of qkv
    k3, v3 = qkv[:, 4 * D:8 * D].view(5, 4, D), qkv[:, 8 * D:].view(5, 4, D)
    want = kv_quant_int8_plain(k3, v3)
    n0 = builder.launches["kv_quant_int8"]
    for g, w in zip(kv_quant_int8(k3, v3), want):
        assert torch.equal(g, w)
    pool = tuple(torch.zeros(s, dtype=dt, device=dev) for s, dt in (
        ((2, 9, 4, 16, D), torch.int8), ((2, 9, 4, 1, 16), torch.float32),
        ((2, 9, 4, 16, D), torch.int8), ((2, 9, 4, 1, 16), torch.float32)))
    blk = torch.tensor([3, 0, 8, 1, 5], dtype=torch.int32, device=dev)
    rows = torch.tensor([0, 15, 7, 2, 9], dtype=torch.int32, device=dev)
    kv_quant_int8(k3, v3, out=pool, layer=_lid(dev), blocks=blk, rows=rows)
    ref = tuple(t.cpu() for t in pool)
    ref = tuple(torch.zeros_like(t) for t in ref)
    kv_quant_int8(k3.cpu(), v3.cpu(), out=ref, layer=LAYER,
                  blocks=blk.cpu(), rows=rows.cpu())
    for g, w in zip(pool, ref):
        assert torch.equal(g.cpu(), w)
    cache = tuple(torch.zeros(s, dtype=dt, device=dev) for s, dt in (
        ((2, 5, 4, 32, D), torch.int8), ((2, 5, 4, 1, 32), torch.float32),
        ((2, 5, 4, 32, D), torch.int8), ((2, 5, 4, 1, 32), torch.float32)))
    off = torch.tensor([19], dtype=torch.int32, device=dev)
    kv_quant_int8(k3, v3, out=cache, layer=_lid(dev), rows=off)
    assert torch.equal(cache[0][LAYER, :, :, 19], want[0])
    assert torch.equal(cache[3][LAYER, :, :, 0, 19], want[3][..., 0])
    torch.cuda.synchronize()
    assert builder.launches["kv_quant_int8"] == n0 + 3


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 4])
def test_cuda_paged_attention_int8_matches_plain(cuda_device, R):
    dev = cuda_device
    q, pools, pos, pt = _paged_int8(np.random.RandomState(8), R=R)
    kc, ks, vc, vs = (torch.from_numpy(a).to(dev) for a in pools)
    args = (_dev(q, dev), kc, vc, torch.from_numpy(pos).to(dev),
            torch.from_numpy(pt).to(dev))
    n0 = builder.launches["decode_attention_paged"]
    got = decode_attention_paged(*args, _lid(dev), k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert builder.launches["decode_attention_paged"] == n0 + 1
    assert torch.count_nonzero(got[2]) == 0
    tolerance.check_kernel("decode_attention_paged[int8]", got,
                           decode_attention_paged_plain(
                               *args, LAYER, k_scale=ks, v_scale=vs))


@pytest.mark.gpu
@pytest.mark.parametrize("int8,R,D", [(True, 1, 128), (True, 4, 128),
                                      (False, 4, 128), (False, 1, 64)])
def test_cuda_stacked_attention_matches_plain(cuda_device, int8, R, D):
    dev = cuda_device
    rs = np.random.RandomState(9)
    Lyr, B, Hkv, L = 2, 3, 2, 256
    q = _dev(0.3 * rs.randn(B, Hkv, R, D), dev)
    pos = torch.tensor([137], dtype=torch.int32, device=dev)
    if int8:
        kc, vc = (torch.from_numpy(_codes(rs, Lyr, B, Hkv, L, D)).to(dev)
                  for _ in range(2))
        ks, vs = (torch.from_numpy(_scales(rs, Lyr, B, Hkv, 1, L) * 0.01)
                  .to(dev) for _ in range(2))
        kw, key = dict(k_scale=ks, v_scale=vs), "decode_attention_stacked[int8]"
    else:
        kc, vc = (_dev(rs.randn(Lyr, B, Hkv, L, D), dev) for _ in range(2))
        kw, key = {}, "decode_attention_stacked"
    n0 = builder.launches["decode_attention_stacked"]
    got = decode_attention_stacked(q, kc, vc, pos, _lid(dev), **kw)
    torch.cuda.synchronize()
    assert builder.launches["decode_attention_stacked"] == n0 + 1
    tolerance.check_kernel(key, got, decode_attention_stacked_plain(
        q, kc, vc, pos, LAYER, **kw))


@pytest.mark.gpu
def test_cuda_int8_weight_kernels_match_plain(cuda_device):
    dev = cuda_device
    rs = np.random.RandomState(10)
    B, E, N, F = 8, 1024, 1536, 2816
    x = _dev(rs.randn(B, E), dev)
    ln_w = _dev(1 + 0.1 * rs.randn(3, E), dev, torch.float32)
    w = torch.from_numpy(_codes(rs, 3, E, N)).to(dev)
    s = _dev(_scales(rs, 3) * 1e-3, dev, torch.float32)
    tolerance.check_kernel(
        "ln_qkv_stacked[int8]",
        ln_qkv_stacked(x, ln_w, None, w, s, None, _lid(dev), norm="rms"),
        ln_qkv_stacked_plain(x, ln_w, None, w, s, None, LAYER, norm="rms"))
    tolerance.check_kernel("matvec_stacked[int8]",
                           matvec_stacked(x, w[:, :, :E].contiguous(), s,
                                          _lid(dev)),
                           matvec_stacked_plain(x, w[:, :, :E], s, LAYER))
    wg, wu = (torch.from_numpy(_codes(rs, 3, E, F)).to(dev) for _ in range(2))
    wd = torch.from_numpy(_codes(rs, 3, F, E)).to(dev)
    args = (None, x, None, None, None, ln_w, None, wg, s, None, wd, s, None)
    kw = dict(act="swiglu", norm="rms", w1b_stack=wu, s1b=s, fuse_proj=False)
    tolerance.check_kernel("out_ffn_stacked[swiglu,int8]",
                           out_ffn_stacked(*args, _lid(dev), **kw),
                           out_ffn_stacked_plain(*args, LAYER, **kw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out_ffn_stacked(x, x, w[:, :, :E].contiguous(), s, ln_w, ln_w, ln_w,
                        wg, s, torch.zeros(3, F, device=dev), wd, s, ln_w,
                        _lid(dev), act="gelu")
