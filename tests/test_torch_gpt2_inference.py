"""deepspeed_tpu_torch GPT-2 ``generate()`` through the fused inference
layer, int8 weights and KV cache, vs the JAX package.

On the CPU, at fp32: the plain versions of the four unstacked decode
kernels (``matvec_int8``, ``ln_qkv_int8``, ``decode_attention_int8``,
``out_ffn_int8``) and GPT-2's int8 contract of the stacked ones against
their Pallas functions in interpret mode, at head dim 64, with codes of
-128 and ``pos`` 0; ``quantize_inference_params`` bit for bit; the
prompt pass's logits and cache against JAX's; greedy ``generate`` token
for token against JAX's on ``tests/test_gpt2_inference.py``'s
``_parity_case`` geometry, every {bf16, int8} weights x {bf16, int8}
cache combination, both ``scan_decode`` settings and with the fast route
forced off; and the GPT-2 paged engine with int8 weights and pool against
the JAX engine. On the card (``gpu`` marker) each CUDA kernel against its
plain version.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import builder, decode, tolerance
from deepspeed_tpu_torch.ops.cuda.decode import (
    decode_attention_int8, decode_attention_int8_plain,
    decode_attention_paged, decode_attention_paged_plain,
    decode_attention_stacked, decode_attention_stacked_plain, ln_qkv_int8,
    ln_qkv_int8_plain, ln_qkv_stacked, ln_qkv_stacked_plain, matvec_int8,
    matvec_int8_plain, out_ffn_int8, out_ffn_int8_plain, out_ffn_stacked,
    out_ffn_stacked_plain)
from torch_port_common import assert_close, cuda_device, t32  # noqa: F401

LAYER = 1


def _jax():
    """(jax, jax.numpy, the Pallas decode module), imported here so the
    gpu tests also run where JAX is not installed."""
    return (importlib.import_module("jax"),
            importlib.import_module("jax.numpy"),
            importlib.import_module("deepspeed_tpu.ops.pallas.decode"))


def _codes(rs, *shape):
    """int8 codes over the whole range, -128 included."""
    c = rs.randint(-128, 128, size=shape).astype(np.int8)
    c.reshape(-1)[::97] = -128
    return c


def _scales(rs, *shape):
    return np.asarray(0.5 + rs.rand(*shape), np.float32)


def _vec(rs, *shape, scale=0.1):
    return (scale * rs.randn(*shape)).astype(np.float32)


def _gpt2_layer(rs, E=128, F=256, L=None):
    """One GPT-2 layer's int8 weights (or a stack of L), per-tensor
    scales, LayerNorm parameters and biases, as numpy."""
    lead = () if L is None else (L,)
    sc = (lambda: _scales(rs) * 1e-3) if L is None else \
        (lambda: _scales(rs, L) * 1e-3)
    return dict(
        ln1_w=1 + _vec(rs, *lead, E), ln1_b=_vec(rs, *lead, E),
        wq=_codes(rs, *lead, E, 3 * E), sq=sc(), bq=_vec(rs, *lead, 3 * E),
        wp=_codes(rs, *lead, E, E), sp=sc(), bp=_vec(rs, *lead, E),
        ln2_w=1 + _vec(rs, *lead, E), ln2_b=_vec(rs, *lead, E),
        w1=_codes(rs, *lead, E, F), s1=sc(), b1=_vec(rs, *lead, F),
        w2=_codes(rs, *lead, F, E), s2=sc(), b2=_vec(rs, *lead, E))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cache8(rs, B, H, L, D, lead=()):
    return (_codes(rs, *lead, B, H, L, D), _scales(rs, *lead, B, H, L) * 0.01,
            _codes(rs, *lead, B, H, L, D), _scales(rs, *lead, B, H, L) * 0.01)


# ------------------------------------------------ plain versions vs JAX

@pytest.mark.parametrize("act", [None, "gelu_tanh", "gelu"])
def test_matvec_int8_plain_matches_pallas(act):
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(0)
    x, wq = rs.randn(3, 256).astype(np.float32), _codes(rs, 256, 384)
    s, b = np.float32(2e-3), _vec(rs, 384)
    want = jdec.matvec_int8(jnp.asarray(x), jnp.asarray(wq), s,
                            jnp.asarray(b), act=act)
    got = matvec_int8(t32(x), _t(wq), torch.tensor(s), t32(b), act=act)
    assert_close(got, np.asarray(want))


def test_ln_qkv_int8_plain_matches_pallas():
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(1)
    a = _gpt2_layer(rs)
    x = rs.randn(3, 128).astype(np.float32)
    want = jdec.ln_qkv_int8(jnp.asarray(x), jnp.asarray(a["ln1_w"]),
                            jnp.asarray(a["ln1_b"]), jnp.asarray(a["wq"]),
                            a["sq"], jnp.asarray(a["bq"]), eps=1e-5)
    got = ln_qkv_int8(t32(x), t32(a["ln1_w"]), t32(a["ln1_b"]), _t(a["wq"]),
                      torch.tensor(a["sq"]), t32(a["bq"]), eps=1e-5)
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
def test_out_ffn_int8_plain_matches_pallas(act):
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(2)
    a = _gpt2_layer(rs)
    ctx, x = rs.randn(3, 128).astype(np.float32), \
        rs.randn(3, 128).astype(np.float32)
    names = ("wp", "sp", "bp", "ln2_w", "ln2_b", "w1", "s1", "b1", "w2", "s2",
             "b2")
    want = jdec.out_ffn_int8(jnp.asarray(ctx), jnp.asarray(x),
                             *(jnp.asarray(a[n]) for n in names), act=act)
    got = out_ffn_int8(t32(ctx), t32(x), *(_t(a[n]) for n in names), act=act)
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("pos", [0, 137, 255])
def test_decode_attention_int8_plain_matches_pallas(pos):
    """q [B, H, 1, 64] over an int8 [B, H, L, D] cache with [B, H, L]
    scales, one position for every row; the tail past pos holds data."""
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(3)
    B, H, L, D = 3, 4, 256, 64
    q = (0.3 * rs.randn(B, H, 1, D)).astype(np.float32)
    kc, ks, vc, vs = _cache8(rs, B, H, L, D)
    want = jdec.decode_attention_int8(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(ks), jnp.asarray(vc),
        jnp.asarray(vs), pos, scale=1.0 / math.sqrt(D))
    got = decode_attention_int8(t32(q), _t(kc), t32(ks), _t(vc), t32(vs),
                                torch.tensor([pos], dtype=torch.int32),
                                scale=1.0 / math.sqrt(D))
    assert_close(got, np.asarray(want))
    # scales past pos never reach the result
    ks[..., pos + 1:] = vs[..., pos + 1:] = np.nan
    assert_close(decode_attention_int8_plain(t32(q), _t(kc), t32(ks), _t(vc),
                                             t32(vs), pos), got)


def test_gpt2_int8_contract_of_stacked_kernels_matches_pallas():
    """ln_qkv_int8_stacked with LayerNorm and biases and
    out_ffn_int8_stacked with gelu_tanh and the fused o-projection, over
    int8 codes with per-layer scales (the fast route's and the paged
    engine's int8 GPT-2 launches)."""
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(4)
    a = _gpt2_layer(rs, L=3)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: _t(v) for k, v in a.items()}
    x, ctx = rs.randn(3, 128).astype(np.float32), \
        rs.randn(3, 128).astype(np.float32)
    want = jdec.ln_qkv_int8_stacked(jnp.asarray(x), j["ln1_w"], j["ln1_b"],
                                    j["wq"], j["sq"], j["bq"], LAYER)
    got = ln_qkv_stacked(t32(x), t["ln1_w"], t["ln1_b"], t["wq"], t["sq"],
                         t["bq"], LAYER)
    assert_close(got, np.asarray(want))
    names = ("wp", "sp", "bp", "ln2_w", "ln2_b", "w1", "s1", "b1", "w2", "s2",
             "b2")
    want = jdec.out_ffn_int8_stacked(jnp.asarray(ctx), jnp.asarray(x),
                                     *(j[n] for n in names), LAYER,
                                     act="gelu_tanh")
    got = out_ffn_stacked(t32(ctx), t32(x), *(t[n] for n in names), LAYER,
                          act="gelu_tanh")
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("pos", [0, 200])
def test_stacked_and_paged_attention_int8_d64_plain_match_pallas(pos):
    """The int8 cache at head dim 64: decode_attention_int8_stacked
    (the fast route) and decode_attention_paged over an int8 pool (the
    paged engine)."""
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(5)
    Lyr, B, H, L, D = 2, 3, 4, 256, 64
    q = (0.3 * rs.randn(B, H, 1, D)).astype(np.float32)
    kc, ks, vc, vs = _cache8(rs, B, H, L, D, lead=(Lyr,))
    ks, vs = ks[:, :, :, None], vs[:, :, :, None]
    want = jdec.decode_attention_int8_stacked(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(ks), jnp.asarray(vc),
        jnp.asarray(vs), pos, LAYER)
    got = decode_attention_stacked(
        t32(q), _t(kc), _t(vc), torch.tensor([pos], dtype=torch.int32),
        LAYER, k_scale=t32(ks), v_scale=t32(vs))
    assert_close(got, np.asarray(want))
    NB, P = 9, 16
    pool = (_codes(rs, Lyr, NB, H, P, D), _scales(rs, Lyr, NB, H, 1, P) * .01,
            _codes(rs, Lyr, NB, H, P, D), _scales(rs, Lyr, NB, H, 1, P) * .01)
    pt = np.array([[5, 3, 0, 0], [1, 8, 2, 7], [6, 0, 0, 0]], np.int32)
    pp = np.array([min(pos, 20), min(pos, 58), -1], np.int32)
    want = jdec.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(pool[0]), jnp.asarray(pool[2]),
        jnp.asarray(pp), jnp.asarray(pt), LAYER, k_scale=jnp.asarray(pool[1]),
        v_scale=jnp.asarray(pool[3]), scale=1.0 / math.sqrt(D))
    got = decode_attention_paged(
        t32(q), _t(pool[0]), _t(pool[2]), _t(pp), _t(pt), LAYER,
        k_scale=t32(pool[1]), v_scale=t32(pool[3]))
    assert_close(got, np.asarray(want))


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("pos", [256, 263])
def test_stacked_attention_plain_past_the_cache_matches_pallas(int8, pos):
    """A position at or past the cache's length (the fast route's step
    past ``max_out_tokens``, whose x is NaN-poisoned) attends over all L
    keys, as the Pallas kernels' mask ``k_pos <= pos`` does."""
    _, jnp, jdec = _jax()
    rs = np.random.RandomState(6)
    Lyr, B, H, L, D = 2, 2, 4, 256, 64
    q = (0.3 * rs.randn(B, H, 1, D)).astype(np.float32)
    p = torch.tensor([pos], dtype=torch.int32)
    if int8:
        kc, ks, vc, vs = _cache8(rs, B, H, L, D, lead=(Lyr,))
        ks, vs = ks[:, :, :, None], vs[:, :, :, None]
        want = jdec.decode_attention_int8_stacked(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(ks),
            jnp.asarray(vc), jnp.asarray(vs), pos, LAYER)
        got = decode_attention_stacked(t32(q), _t(kc), _t(vc), p, LAYER,
                                       k_scale=t32(ks), v_scale=t32(vs))
    else:
        kc, vc = (rs.randn(Lyr, B, H, L, D).astype(np.float32)
                  for _ in range(2))
        want = jdec.decode_attention_fp_stacked(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), pos, LAYER)
        got = decode_attention_stacked(t32(q), t32(kc), t32(vc), p, LAYER)
    assert_close(got, np.asarray(want))


# ------------------------------------------------------------ on the card

def _dev(a, dev, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(a)).to(dev).to(dtype)


def _dev_layer(a, dev):
    """A _gpt2_layer dict on the card: codes int8, activations' and
    weights' companions fp32 (scales one-element tensors)."""
    out = {}
    for k, v in a.items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(v.reshape(-1) if v.ndim == 0 else v).to(dev)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "gelu_tanh", "gelu"])
@pytest.mark.parametrize("B", [1, 8])
def test_cuda_matvec_int8_matches_plain(cuda_device, act, B):
    dev = cuda_device
    rs = np.random.RandomState(10)
    x = _dev(rs.randn(B, 1280), dev)
    wq = torch.from_numpy(_codes(rs, 1280, 5120)).to(dev)
    s = torch.tensor([2e-3], device=dev)
    b = _dev(_vec(rs, 5120), dev, torch.float32)
    n0 = builder.launches["matvec_int8"]
    got = matvec_int8(x, wq, s, b, act=act)
    torch.cuda.synchronize()
    assert builder.launches["matvec_int8"] == n0 + 1
    tolerance.check_kernel("matvec_int8", got,
                           matvec_int8_plain(x, wq, s, b, act=act))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8])
def test_cuda_ln_qkv_and_out_ffn_int8_match_plain(cuda_device, B):
    """The unstacked kernels and GPT-2's int8 contract of the stacked ones
    at GPT-2 large's widths."""
    dev = cuda_device
    rs = np.random.RandomState(11)
    E, F = 1280, 5120
    a = _dev_layer(_gpt2_layer(rs, E, F), dev)
    x, ctx = _dev(rs.randn(B, E), dev), _dev(0.3 * rs.randn(B, E), dev)
    args = (a["ln1_w"], a["ln1_b"], a["wq"], a["sq"], a["bq"])
    tolerance.check_kernel("ln_qkv_int8", ln_qkv_int8(x, *args),
                           ln_qkv_int8_plain(x, *args))
    ffn = [a[n] for n in ("wp", "sp", "bp", "ln2_w", "ln2_b", "w1", "s1",
                          "b1", "w2", "s2", "b2")]
    tolerance.check_kernel("out_ffn_int8", out_ffn_int8(ctx, x, *ffn),
                           out_ffn_int8_plain(ctx, x, *ffn))
    st = _dev_layer(_gpt2_layer(rs, E, F, L=3), dev)
    lid = torch.tensor(LAYER, dtype=torch.int32, device=dev)
    args = (st["ln1_w"], st["ln1_b"], st["wq"], st["sq"], st["bq"])
    tolerance.check_kernel("ln_qkv_stacked[ln,int8]",
                           ln_qkv_stacked(x, *args, lid),
                           ln_qkv_stacked_plain(x, *args, LAYER))
    ffn = [st[n] for n in ("wp", "sp", "bp", "ln2_w", "ln2_b", "w1", "s1",
                           "b1", "w2", "s2", "b2")]
    tolerance.check_kernel("out_ffn_stacked[int8]",
                           out_ffn_stacked(ctx, x, *ffn, lid),
                           out_ffn_stacked_plain(ctx, x, *ffn, LAYER))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out_ffn_int8(ctx, x, *[a[n] for n in (
            "wp", "sp", "bp", "ln2_w", "ln2_b", "w1", "s1", "b1", "w2", "s2",
            "b2")], act="gelu")


@pytest.mark.gpu
@pytest.mark.parametrize("D,pos", [(64, 0), (64, 2034), (128, 1000)])
def test_cuda_decode_attention_int8_matches_plain(cuda_device, D, pos):
    """The unstacked and stacked forms over an int8 cache, scales past pos
    NaN (they must not be read), and the paged int8 pool at head dim 64."""
    dev = cuda_device
    rs = np.random.RandomState(12)
    B, H, L = 8, 20 if D == 64 else 8, 2048
    q = _dev(0.3 * rs.randn(B, H, 1, D), dev)
    kc, ks, vc, vs = (torch.from_numpy(a).to(dev)
                      for a in _cache8(rs, B, H, L, D))
    ks[..., pos + 1:] = float("nan")
    vs[..., pos + 1:] = float("nan")
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    n0 = builder.launches["decode_attention_int8"]
    got = decode_attention_int8(q, kc, ks, vc, vs, p)
    torch.cuda.synchronize()
    assert builder.launches["decode_attention_int8"] == n0 + 1
    assert torch.isfinite(got).all()
    want = decode_attention_int8_plain(q, kc, ks, vc, vs, pos)
    tolerance.check_kernel("decode_attention_int8", got, want)
    got = decode_attention_stacked(
        q, kc[None], vc[None], p, torch.zeros(1, dtype=torch.int32,
                                              device=dev),
        k_scale=ks[None, :, :, None], v_scale=vs[None, :, :, None])
    tolerance.check_kernel("decode_attention_stacked[int8,d64]", got, want)
    if D == 64:
        Lyr, NB, P = 2, 9, 16
        pool = [torch.from_numpy(a).to(dev) for a in (
            _codes(rs, Lyr, NB, H, P, D), _scales(rs, Lyr, NB, H, 1, P) * .01,
            _codes(rs, Lyr, NB, H, P, D), _scales(rs, Lyr, NB, H, 1, P) * .01)]
        pt = torch.tensor([[5, 3, 0, 0], [1, 8, 2, 7], [6, 0, 0, 0]],
                          dtype=torch.int32, device=dev)
        pp = torch.tensor([20, 58, -1], dtype=torch.int32, device=dev)
        q3 = q[:3].contiguous()
        args = (q3, pool[0], pool[2], pp, pt)
        kw = dict(k_scale=pool[1], v_scale=pool[3])
        got = decode_attention_paged(*args, torch.tensor(
            LAYER, dtype=torch.int32, device=dev), **kw)
        assert torch.count_nonzero(got[2]) == 0
        tolerance.check_kernel("decode_attention_paged[int8,d64]", got,
                               decode_attention_paged_plain(*args, LAYER,
                                                            **kw))


# ------------------------------------------------- the model and generate

# tests/test_gpt2_inference.py's _parity_case geometry: E 256, 3 layers, 4
# heads of 64, ctx 192, vocab 512 (E a multiple of 128: the fused int8
# step and the fast route are taken)
GEOM = dict(vocab_size=512, n_positions=192, n_embd=256, n_layer=3,
            n_head=4)
CTX, NEW = 192, 8
COMBOS = [(0, 0), (8, 8), (0, 8), (8, 0)]       # (quantize_bits, kv bits)


def _cfgs(**kw):
    _, jnp, _ = _jax()
    from deepspeed_tpu.models.gpt2 import GPT2Config as JCfg
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    g = dict(GEOM, **kw)
    return (JCfg(dtype=jnp.float32, param_dtype=jnp.float32,
                 scan_layers=True, **g),
            GPT2Config(dtype=torch.float32, **g))


def _inference_tree(rs, cfg, tied=True):
    """A converted inference tree (numpy) whose greedy decoding does not
    settle on one token: N(0, 0.1) embeddings, N(0, 2/sqrt(in)) matrices
    (at flax's init, or with embeddings that outweigh the layers, the
    tied head repeats one token), LayerNorm scales near 1, small
    biases."""
    E, L, V, P = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.n_positions

    def mat(i, o):
        return (rs.randn(L, i, o) * 2 / np.sqrt(i)).astype(np.float32)

    def ln():
        return {"scale": 1 + _vec(rs, L, E), "bias": _vec(rs, L, E)}
    blk = {"attn_nw": ln(), "norm_w": ln(),
           "attn_qkvw": {"kernel": mat(E, 3 * E), "bias": _vec(rs, L, 3 * E)},
           "attn_ow": {"kernel": mat(E, E), "bias": _vec(rs, L, E)},
           "inter_w": {"kernel": mat(E, 4 * E), "bias": _vec(rs, L, 4 * E)},
           "output_w": {"kernel": mat(4 * E, E), "bias": _vec(rs, L, E)}}
    tree = {"wte": _vec(rs, V, E), "wpe": _vec(rs, P, E),
            "ln_f": {"scale": 1 + _vec(rs, E), "bias": _vec(rs, E)},
            "h": {"blk": blk}}
    if not tied:
        tree["lm_head"] = {"kernel": _vec(rs, E, V, scale=0.3)}
    return tree


def _np_tree(tree):
    jax, _, _ = _jax()
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model_case():
    """(jcfg, cfg, fp tree, JAX-quantized tree, prompt [2, 40])."""
    from deepspeed_tpu.models.gpt2_inference import \
        quantize_gpt2_inference_params
    jcfg, cfg = _cfgs()
    rs = np.random.RandomState(13)
    tree = _inference_tree(rs, cfg)
    q8 = _np_tree(quantize_gpt2_inference_params(tree))
    prompt = rs.randint(0, 512, size=(2, 40)).astype(np.int32)
    return jcfg, cfg, tree, q8, prompt


@pytest.fixture(scope="module")
def jax_tokens(model_case):
    """JAX's greedy generate tokens by (quantize_bits, kv bits, route),
    each run once: route "fast" (scan_decode, the stacked loop), "scan"
    (scan_decode with _supports_fast_decode patched false: decode_scan
    over the flax layers) and "step" (scan_decode=False)."""
    import deepspeed_tpu.models.gpt2_inference as gi
    jcfg, _, tree, q8, prompt = model_case
    memo = {}

    def get(qb, kv, route):
        if (qb, kv, route) not in memo:
            orig = gi._supports_fast_decode
            if route == "scan":
                gi._supports_fast_decode = lambda *a: False
            try:
                memo[qb, kv, route] = np.asarray(gi.generate(
                    jcfg, q8 if qb else tree, prompt, max_new_tokens=NEW,
                    max_out_tokens=CTX, scan_decode=route != "step",
                    quantize_bits=qb, kv_cache_bits=kv))
            finally:
                gi._supports_fast_decode = orig
        return memo[qb, kv, route]
    return get


@pytest.mark.parametrize("route", ["fast", "scan", "step"])
@pytest.mark.parametrize("qb,kv", COMBOS)
def test_generate_matches_jax(model_case, jax_tokens, monkeypatch, qb, kv,
                              route):
    """Greedy tokens equal JAX's for every weights x cache combination on
    each of JAX's routes: the stacked fast loop, the fast route forced off
    (JAX's decode_scan) and scan_decode=False (its step loop); the last
    two are the port's per-token loop, whose layers take the fused int8
    step with int8 weights and cache."""
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    _, cfg, tree, q8, prompt = model_case
    if route == "scan":
        monkeypatch.setattr(gi, "_supports_fast_decode", lambda *a: False)
    n0 = dict(builder.launches)
    got = gi.generate(cfg, q8 if qb else tree, prompt, max_new_tokens=NEW,
                      max_out_tokens=CTX, scan_decode=route != "step",
                      quantize_bits=qb, kv_cache_bits=kv, device="cpu")
    want = jax_tokens(qb, kv, route)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[:, 40:].reshape(-1).tolist())) > 4   # not one token
    assert dict(builder.launches) == n0          # the CPU launches nothing


def test_generate_takes_jax_routes(model_case, monkeypatch):
    """Which kernels each route calls, counted through the modules' names:
    the fast loop the stacked kernels, the per-token loop with int8
    weights and cache the four unstacked ones per layer per step, with
    bf16 weights and an int8 cache decode_attention_int8 alone."""
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    from deepspeed_tpu_torch.ops.transformer import inference as inf
    _, cfg, tree, q8, prompt = model_case
    calls = {}

    def count(mod, name):
        real = getattr(mod, name)

        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    for name in ("ln_qkv_int8", "kv_quant_int8", "decode_attention_int8",
                 "out_ffn_int8"):
        count(inf, name)
    for name in ("ln_qkv_stacked", "kv_quant_int8",
                 "decode_attention_stacked", "out_ffn_stacked"):
        count(gi, name)
    steps = cfg.n_layer * (NEW - 1)
    for qb, kv, scan, want in (
            (8, 8, False, {"ln_qkv_int8": steps, "kv_quant_int8": steps,
                           "decode_attention_int8": steps,
                           "out_ffn_int8": steps}),
            (0, 8, False, {"decode_attention_int8": steps}),
            (8, 8, True, {"ln_qkv_stacked": steps, "kv_quant_int8": steps,
                          "decode_attention_stacked": steps,
                          "out_ffn_stacked": steps}),
            (0, 0, True, {"ln_qkv_stacked": steps,
                          "decode_attention_stacked": steps,
                          "out_ffn_stacked": steps})):
        calls.clear()
        gi.generate(cfg, q8 if qb else tree, prompt, max_new_tokens=NEW,
                    max_out_tokens=CTX, scan_decode=scan, quantize_bits=qb,
                    kv_cache_bits=kv, device="cpu")
        assert calls == want, (qb, kv, scan, calls)
    assert not gi._supports_fast_decode(cfg, 65, 0, 1, 0)
    assert not gi._supports_fast_decode(cfg, 2, 8, 4, 8)
    assert gi._supports_fast_decode(cfg, 64, 8, 1, 8)


@pytest.mark.parametrize("qb,kv", COMBOS)
def test_prompt_pass_matches_jax(model_case, qb, kv):
    """The prompt pass's last logits at 2e-5 and its cache against JAX's
    jitted prompt_pass: cache_index, and over an int8 cache the codes
    (the rare code one unit off where the K/V rows differ in their last
    fp32 bit, from the products' summation order, is counted) and scales
    to 2e-5; a bf16 cache's rows to 2e-5. JAX runs as tests/conftest.py
    sets it, XLA's optimizations off; with them on, XLA rewrites the
    dequantized int8 product and the int8 x int8 case parts by ~3e-3 in
    the logits (its quantizer stays bit-equal: the test below)."""
    from deepspeed_tpu.models.gpt2_inference import _compiled_steps
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    jcfg, cfg, tree, q8, prompt = model_case
    prompt_pass = _compiled_steps(jcfg, CTX, qb, 1, kv, 1)[0]
    jl, jc = prompt_pass(q8 if qb else tree, prompt)
    jc = _np_tree(jc)["h"]["blk"]
    p = gi.serving_params(q8 if qb else tree, cfg, "cpu", qb)
    model = gi.GPT2InferenceModel(cfg, p, CTX, qb, 1, kv)
    cache = model.make_cache(2)
    logits = model(torch.from_numpy(prompt).long(), cache)[:, -1]
    assert_close(logits, np.asarray(jl))
    assert int(cache.index) == 40 and np.all(jc["cache_index"] == 40)
    if kv == 8:
        for got, key in ((cache.k, "cached_key_q8"),
                         (cache.v, "cached_value_q8")):
            diff = np.abs(got.numpy().astype(int) - jc[key].astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, key
        assert_close(cache.k_scale, jc["key_scale"])
        assert_close(cache.v_scale, jc["value_scale"])
        assert not cache.k[:, :, :, 40:].any()
    else:
        assert_close(cache.k, jc["cached_key"])
        assert_close(cache.v, jc["cached_value"])


@pytest.mark.parametrize("S", [1, 5])
def test_cache_quantization_bit_equal_to_jax(S):
    """The int8 cache write on identical rows: JAX's own ``_cache_int8``
    (jitted, as the prompt pass and decode steps run it) against the
    port's, codes and scales bit for bit, at a nonzero cache_index."""
    jax, jnp, _ = _jax()
    from deepspeed_tpu.ops.transformer.inference import (
        DeepSpeedInferenceConfig as JCfg, DeepSpeedTransformerInference as
        JLayer)
    from deepspeed_tpu_torch.ops.transformer.inference import (
        DeepSpeedInferenceConfig, DeepSpeedTransformerInference, KVCache)
    rs = np.random.RandomState(7)
    B, H, L, D = 2, 4, 32, 64
    kh = (rs.randn(B, H, S, D) * rs.rand(B, H, S, 1) * 3).astype(np.float32)
    vh = rs.randn(B, H, S, D).astype(np.float32)
    kh[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]            # exact halves
    vh[1, 1] = 0.0                                       # scale 1e-12
    import flax.linen as fnn

    class Write(JLayer):
        """JAX's layer, called on its cache write alone."""
        @fnn.compact
        def __call__(self, kh, vh):
            return self._cache_int8(kh, vh, B, L, H, D)
    jl = Write(JCfg(hidden_size=H * D, heads=H, kv_cache_bits=8,
                    max_out_tokens=L, dtype=jnp.float32))
    cache = {"cached_key_q8": jnp.zeros((B, H, L, D), jnp.int8),
             "cached_value_q8": jnp.zeros((B, H, L, D), jnp.int8),
             "key_scale": jnp.zeros((B, H, L)),
             "value_scale": jnp.zeros((B, H, L)),
             "cache_index": jnp.asarray(3, jnp.int32)}
    write = jax.jit(lambda c, k, v: jl.apply(
        {"cache": c}, k, v, mutable=["cache"])[1]["cache"])
    want = _np_tree(write(cache, kh, vh))
    layer = DeepSpeedTransformerInference(DeepSpeedInferenceConfig(
        hidden_size=H * D, heads=H, kv_cache_bits=8, max_out_tokens=L))
    got = KVCache.zeros(1, B, H, L, D, torch.float32, 8, "cpu").layer(0)
    got.index.fill_(3)
    layer._cache_write(t32(kh), t32(vh), got)
    for g, key in ((got.k, "cached_key_q8"), (got.v, "cached_value_q8"),
                   (got.k_scale, "key_scale"), (got.v_scale, "value_scale")):
        np.testing.assert_array_equal(g.numpy(), want[key])


def test_quantize_inference_params_bit_equal_to_jax(model_case):
    """quantize_inference_params on a layer-stacked tree and on one
    layer's 2-D kernels, groups 1 and 4: codes and scales bit for bit
    (an exact -amax planted); quantize_gpt2_inference_params on the port's
    stacked weights equals JAX's tree carried across."""
    from deepspeed_tpu.ops.transformer.inference import \
        quantize_inference_params as jquant
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    from deepspeed_tpu_torch.ops.transformer.inference import \
        quantize_inference_params
    _, cfg, tree, _, _ = model_case
    blk = tree["h"]["blk"]
    one = {k: {"kernel": v["kernel"][1], "bias": v["bias"][1]}
           for k, v in blk.items() if "kernel" in v}
    one["attn_qkvw"]["kernel"][0, :2] = [-4.0, 127 / 32]  # codes -127, 126
    for groups in (1, 4):
        for sub in (blk, one):
            want = _np_tree(jquant(sub, bits=8, groups=groups))
            got = quantize_inference_params(
                {k: {n: t32(a) for n, a in v.items()} for k, v in sub.items()},
                bits=8, groups=groups)
            for name in ("attn_qkvw", "attn_ow", "inter_w", "output_w"):
                for leaf in ("kernel_q", "kernel_scale"):
                    np.testing.assert_array_equal(got[name][leaf].numpy(),
                                                  want[name][leaf])
        mine = gi.quantize_gpt2_inference_params(
            gi.from_jax_params(tree, cfg, "cpu"), groups=groups)
        theirs = gi.from_jax_params(_np_tree(jquant(tree, groups=groups)),
                                    cfg, "cpu")
        assert mine.keys() == theirs.keys()
        for k in theirs:
            assert mine[k].dtype == theirs[k].dtype and torch.equal(
                mine[k], theirs[k]), k


def test_generate_untied_head_and_sampling(model_case):
    """An untied lm_head (the per-token route: the fast loop needs the
    tied head) matches JAX's greedy tokens; a sampled run keeps shape,
    range and its tokens under one generator seed, and another seed draws
    other tokens; the over-long request asserts as JAX's does."""
    from deepspeed_tpu.models.gpt2_inference import generate as jgen
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    jcfg, cfg = _cfgs(tie_word_embeddings=False)
    tree = _inference_tree(np.random.RandomState(3), cfg, tied=False)
    _, _, _, _, prompt = model_case
    want = np.asarray(jgen(jcfg, tree, prompt, max_new_tokens=6,
                           max_out_tokens=CTX))
    got = gi.generate(cfg, tree, prompt, max_new_tokens=6,
                      max_out_tokens=CTX, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    _, cfg, tree, q8, _ = model_case

    def sample(seed):
        return gi.generate(cfg, q8, prompt, max_new_tokens=10,
                           temperature=1.0, max_out_tokens=CTX,
                           quantize_bits=8, kv_cache_bits=8, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    a = sample(3)
    assert a.shape == (2, 50) and torch.equal(a[:, :40],
                                              torch.from_numpy(prompt).long())
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size
    assert torch.equal(a, sample(3)) and not torch.equal(a, sample(4))
    with pytest.raises(AssertionError):
        gi.generate(cfg, tree, prompt, max_new_tokens=160, device="cpu")
    with pytest.raises(ValueError, match="quantize_bits"):
        gi.generate(cfg, tree, prompt, max_new_tokens=2, quantize_bits=8,
                    device="cpu")


def test_inference_config_validation_and_refusals():
    """The JAX config's validation messages; MoE layers and mp_size > 1
    raise NotImplementedError naming ROADMAP."""
    from deepspeed_tpu.ops.transformer.inference import \
        DeepSpeedInferenceConfig as JCfg
    from deepspeed_tpu_torch.ops.transformer.inference import \
        DeepSpeedInferenceConfig
    for bad in ({"kv_cache_bits": 4}, {"quantize_bits": 4}):
        with pytest.raises(ValueError) as want:
            JCfg(hidden_size=32, heads=2, **bad)
        with pytest.raises(ValueError) as got:
            DeepSpeedInferenceConfig(hidden_size=32, heads=2, **bad)
        assert str(got.value) == str(want.value)
    for bad in ({"moe_experts": 4}, {"mp_size": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DeepSpeedInferenceConfig(hidden_size=32, heads=2, **bad)


@pytest.mark.parametrize("qb,kv", [(0, 0), (8, 8)])
def test_decode_past_cache_poisons_with_nan(qb, kv):
    """Overflowing max_out_tokens is loud (NaN), not silently stale, on
    the general path and on the fused int8 step, as JAX's layer
    (tests/test_module_inject.py:212): single-token steps into a cache of
    4, finite for 4 steps, NaN after."""
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    from deepspeed_tpu_torch.ops.transformer.inference import (
        DeepSpeedInferenceConfig, DeepSpeedTransformerInference, KVCache)
    _, cfg = _cfgs()
    p = gi.serving_params(_inference_tree(np.random.RandomState(4), cfg),
                          cfg, "cpu")
    if qb:
        p = gi.quantize_gpt2_inference_params(p)
    layer = DeepSpeedTransformerInference(DeepSpeedInferenceConfig(
        hidden_size=256, heads=4, max_out_tokens=4, quantize_bits=qb,
        kv_cache_bits=kv, gelu_approximate=True, layer_norm_eps=1e-5,
        dtype=torch.float32))
    w = gi.layer_params(p, 0)
    cache = KVCache.zeros(1, 1, 4, 4, 64, torch.float32, kv, "cpu")
    x = torch.randn(1, 1, 256, generator=torch.Generator().manual_seed(0))
    for t in range(6):
        out = layer(x, w, cache.layer(0))
        cache.advance(1)
        assert bool(torch.isfinite(out).all()) == (t < 4), t


# --------------------------------------------------- the paged engine, int8

SERVING = {"slots": 2, "page_size": 16, "max_pages_per_slot": 6,
           "quantize_bits": 8, "kv_cache_bits": 8}
LENS, NEWS = (5, 21, 11), (9, 6, 4)


@pytest.fixture(scope="module")
def paged_case():
    """tests/test_serving.py's GPT-2 geometry (E 128, 2 layers, 4 heads of
    32): (jcfg, cfg, JAX training tree, prompts, JAX engine results with
    int8 weights and pool)."""
    jax, _, _ = _jax()
    import deepspeed_tpu.serving as jserving
    from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel
    geom = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
                n_head=4)
    jcfg, cfg = _cfgs(**geom)
    params = _np_tree(jax.jit(GPT2LMHeadModel(jcfg).init)(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"])
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, size=(s,)).astype(np.int32) for s in LENS]
    eng = jserving.build_engine("gpt2", jcfg, params,
                                config={"serving": SERVING})
    res = eng.serve([jserving.Request(i, p, max_new_tokens=n)
                     for i, (p, n) in enumerate(zip(prompts, NEWS))])
    return jcfg, cfg, params, prompts, eng, res


def test_paged_int8_engine_matches_jax_engine(paged_case):
    """quantize_bits 8 (the weights quantized at build) and the int8 pool:
    tokens equal to the JAX engine's request by request, the last tick's
    logits at 2e-5, and each request teacher-forced against the int8
    oracle (fp32 dequantized weights, K/V of decode steps rounded through
    the pool's codes)."""
    import deepspeed_tpu_torch.serving as serving
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    _, cfg, params, prompts, jeng, jres = paged_case
    eng = serving.build_engine("gpt2", cfg, params,
                               config={"serving": SERVING}, device="cpu")
    assert eng.adapter.p["inter_w"].dtype == torch.int8
    assert [t.dtype for t in eng.cache.pool] == [
        torch.int8, torch.float32, torch.int8, torch.float32]
    res = eng.serve([serving.Request(i, p, max_new_tokens=n)
                     for i, (p, n) in enumerate(zip(prompts, NEWS))])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(res[i].tokens(), jres[i].tokens())
    assert eng.stats["decode_tokens"] == jeng.stats["decode_tokens"]
    assert_close(eng.last_logits, np.asarray(jeng.last_logits))
    for r in res.values():
        toks, S = r.tokens(), len(r.prompt)
        rows = gi.dense_logits(eng.adapter.p, cfg, toks[:-1], torch.float32,
                               kv_quant_from=S)[S - 1:]
        np.testing.assert_array_equal(rows.argmax(-1).numpy(), toks[S:])


@pytest.mark.parametrize("B,groups,S,fused", [(8, 1, 1, True),
                                              (9, 1, 1, False),
                                              (2, 4, 1, False),
                                              (2, 1, 3, False)])
def test_fused_step_condition(monkeypatch, B, groups, S, fused):
    """The fused int8 step is taken under JAX's condition
    (inference.py:178-188): S == 1, B <= 8, quantize_groups 1 (E and F
    multiples of 128 here); otherwise the general path, whose S == 1
    attention over the int8 cache takes decode_attention_int8 at B <= 8
    only (inference.py:388-390)."""
    from deepspeed_tpu_torch.models import gpt2_inference as gi
    from deepspeed_tpu_torch.ops.transformer import inference as inf
    calls = {}
    for name in ("ln_qkv_int8", "decode_attention_int8"):
        real = getattr(inf, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(inf, name, counted)
    _, cfg = _cfgs(n_layer=1)
    p = gi.quantize_gpt2_inference_params(gi.serving_params(
        _inference_tree(np.random.RandomState(6), cfg), cfg, "cpu"), groups)
    layer = inf.DeepSpeedTransformerInference(gi.inference_config(
        cfg, 16, quantize_bits=8, quantize_groups=groups, kv_cache_bits=8))
    cache = inf.KVCache.zeros(1, B, 4, 16, 64, torch.float32, 8, "cpu")
    x = torch.randn(B, S, 256, generator=torch.Generator().manual_seed(1))
    out = layer(x, gi.layer_params(p, 0), cache.layer(0))
    assert out.shape == (B, S, 256) and bool(torch.isfinite(out).all())
    want = {"ln_qkv_int8": 1, "decode_attention_int8": 1} if fused else (
        {"decode_attention_int8": 1} if S == 1 and B <= 8 else {})
    assert calls == want
