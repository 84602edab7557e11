"""LLaMA serving weights and the dense fast path: the packed layout, int8
codes, the weight bridge, seeded weights, ``llama_fast_generate`` and a
dense forward.

Port of ``deepspeed_tpu/models/llama_inference.py`` (packing :14-18,
``convert_llama_serving_params`` :42, ``quantize_llama_serving_params``
:65, ``random_int8_serving_params`` :87, ``_weights`` :117,
``llama_fast_generate`` :151-396). The serving weights are one flat dict
of layer-stacked tensors, packed as the JAX serving tree packs them::

    qkv_w [L, E, (H + 2*Hkv) * D]   (q | k | v column blocks)
    o_w   [L, H*D, E]   gate_w, up_w [L, E, F]   down_w [L, F, E]
    norm1, norm2 [L, E]; embed [V, E]; head [V, E]; norm_scale [E]

Matrices keep flax's ``[in, out]`` orientation, so the decode kernels
read ``W[l]`` as ``[E, N]`` exactly as the TPU kernels do. Embeddings are
in ``cfg.dtype``, the RMSNorm scales in fp32, and the five layer matrices
either in ``cfg.dtype`` or, quantized (JAX's ``kernel_q``), as int8 codes
with per-layer fp32 scales ``<name>_scale`` [L].
"""

import numpy as np
import torch

from deepspeed_tpu_torch.models.llama import (LlamaConfig, apply_rope,
                                              rms_norm, rope_angles,
                                              rope_rows, rope_tables)
from deepspeed_tpu_torch.ops.attention import dot_product_attention
from deepspeed_tpu_torch.ops.cuda.decode import (decode_attention_stacked,
                                                 fake_quant, ln_qkv_stacked,
                                                 matvec_stacked,
                                                 out_ffn_stacked,
                                                 quantize_rows)
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.sampling import pick_token

# packed name → the training tree's (sub-block, leaf) under layers/blk
_MATS = {"o_w": ("attn", "o_proj"), "gate_w": ("mlp", "gate_proj"),
         "up_w": ("mlp", "up_proj"), "down_w": ("mlp", "down_proj")}
LAYER_MATS = ("qkv_w",) + tuple(_MATS)
SCALE = "_scale"          # int8 codes' per-layer scales: p[name + SCALE]
# LLaMA's o-projection branch (deepspeed_tpu/serving/adapters.py:806,
# models/llama_inference.py:318): a [E, E] weight of at most this many
# bytes fuses into out_ffn_stacked; a larger one runs as matvec_stacked +
# a residual add + out_ffn_stacked(fuse_proj=False)
FUSED_PROJ_MAX_BYTES = 6 << 20


def fused_proj(cfg: LlamaConfig, Wo) -> bool:
    """True when the o-projection ``Wo`` fuses into out_ffn_stacked: the
    branch of the paged engine's tick and of the fast path's decode loop
    alike."""
    E = cfg.hidden_size
    return E * E * Wo.element_size() <= FUSED_PROJ_MAX_BYTES


def param_shapes(cfg: LlamaConfig, int8=False):
    """{name: (shape, kind)} of the packed serving weights; kind is
    "normal" (a matrix or embedding), "ones" (an RMSNorm scale), and with
    ``int8`` "codes" (a layer matrix's int8 codes) or "scale" (their
    per-layer scales)."""
    E, F, L, V = (cfg.hidden_size, cfg.intermediate_size, cfg.n_layers,
                  cfg.vocab_size)
    H, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    mats = {"qkv_w": (L, E, (H + 2 * Hkv) * D), "o_w": (L, H * D, E),
            "gate_w": (L, E, F), "up_w": (L, E, F), "down_w": (L, F, E)}
    out = {"embed": ((V, E), "normal"), "head": ((V, E), "normal"),
           "norm_scale": ((E,), "ones"),
           "norm1": ((L, E), "ones"), "norm2": ((L, E), "ones")}
    for name, shape in mats.items():
        out[name] = (shape, "codes" if int8 else "normal")
        if int8:
            out[name + SCALE] = ((L,), "scale")
    return out


def is_int8(p) -> bool:
    """True for packed weights whose layer matrices are int8 codes."""
    return p["qkv_w"].dtype == torch.int8


def convert_llama_serving_params(params, cfg: LlamaConfig):
    """The JAX scan-stacked ``LlamaForCausalLM`` training tree (leaves
    numpy-convertible) → the JAX packed serving tree, as numpy."""
    if not cfg.scan_layers or "layers" not in params:
        raise ValueError("serving packs the scan-stacked training layout "
                         "(layers/blk/...)")
    blk = params["layers"]["blk"]

    def kernel(sub, name):
        return np.asarray(blk[sub][name]["kernel"])
    qkv = np.concatenate([kernel("attn", "q_proj"), kernel("attn", "k_proj"),
                          kernel("attn", "v_proj")], axis=-1)
    out_blk = {"qkv_w": {"kernel": qkv},
               "norm1": np.asarray(blk["input_norm"]["scale"]),
               "norm2": np.asarray(blk["post_attn_norm"]["scale"])}
    for name, (sub, leaf) in _MATS.items():
        out_blk[name] = {"kernel": kernel(sub, leaf)}
    return {"embed": np.asarray(params["embed_tokens"]),
            "head": np.asarray(params["lm_head"]),
            "norm_scale": np.asarray(params["norm"]["scale"]),
            "blk": out_blk}


def from_jax_serving_params(tree, cfg: LlamaConfig, device):
    """A JAX LLaMA tree (the packed serving tree, fp or int8 ``kernel_q``
    with ``kernel_scale``, or the scan-stacked training tree, which is
    packed first) → the port's packed tensors on ``device``. int8 codes
    stay int8: they are never dequantized on the way."""
    if "layers" in tree:
        tree = convert_llama_serving_params(tree, cfg)
    blk = tree["blk"]
    arrays = {"embed": tree["embed"], "head": tree["head"],
              "norm_scale": tree["norm_scale"], "norm1": blk["norm1"],
              "norm2": blk["norm2"]}
    kinds = {"kernel_q" in blk[name] for name in LAYER_MATS}
    if len(kinds) > 1:
        raise ValueError("a LLaMA serving tree quantizes all five layer "
                         "matrices or none")
    for name in LAYER_MATS:
        sub = blk[name]
        if "kernel_q" in sub:
            arrays[name] = np.asarray(sub["kernel_q"], np.int8)
            arrays[name + SCALE] = sub["kernel_scale"]
        else:
            arrays[name] = sub["kernel"]
    return as_serving_params(
        {k: torch.from_numpy(np.array(
            v, dtype=np.int8 if np.asarray(v).dtype == np.int8
            else np.float32)) for k, v in arrays.items()}, cfg, device)


def as_serving_params(params, cfg: LlamaConfig, device):
    """Check a packed weight dict against ``cfg`` and place it on
    ``device``: embeddings and fp layer matrices in cfg.dtype, int8 codes
    as int8, RMSNorm and code scales in fp32."""
    out = {}
    for name, (shape, kind) in param_shapes(cfg, is_int8(params)).items():
        if name not in params:
            raise ValueError(f"LLaMA weight {name} is missing")
        t = params[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"LLaMA weight {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if (kind == "codes") != (t.dtype == torch.int8) \
                and kind in ("codes", "normal"):
            raise ValueError(f"LLaMA weight {name} is {t.dtype}: the layer "
                             f"matrices are all int8 codes or none")
        dtype = {"normal": cfg.dtype, "codes": torch.int8}.get(
            kind, torch.float32)
        out[name] = t.to(device=device, dtype=dtype).contiguous()
    return out


def quantize_serving_params(p):
    """Packed weights → int8 codes with per-layer scales (port of
    ``quantize_llama_serving_params``): for each layer of each layer
    matrix sc = max(amax / 127, 1e-12) and codes = clip(round(w / sc),
    -127, 127) in fp32, one layer at a time (the fp32 transient is one
    layer's matrix). Embeddings, head and norms are kept as they are."""
    out = {k: v for k, v in p.items() if k not in LAYER_MATS}
    for name in LAYER_MATS:
        w = p[name]
        codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty(w.shape[0], dtype=torch.float32, device=w.device)
        for l in range(w.shape[0]):
            flat = w[l].float()
            sc = torch.clamp_min(flat.abs().amax() / 127.0, 1e-12)
            codes[l] = torch.clamp(torch.round(flat / sc), -127, 127)
            scale[l] = sc
            del flat
        out[name], out[name + SCALE] = codes, scale
    return out


def random_int8_serving_params(cfg: LlamaConfig, seed=0, device=None):
    """Random int8 packed weights from ``np.random.RandomState(seed)``, the
    draws of ``random_int8_serving_params`` (codes in [-80, 80) with scale
    2e-3, bf16 embeddings and head of std 0.01) on ``device``. It draws
    int64 codes on the host: a small model's function (the tests); a
    full-size int8 model is quantized on the card from seeded bf16
    weights (``quantize_serving_params``)."""
    rs = np.random.RandomState(seed)
    E, H, Hkv, D = (cfg.hidden_size, cfg.n_heads, cfg.kv_heads,
                    cfg.head_dim)
    F, L, V = cfg.intermediate_size, cfg.n_layers, cfg.vocab_size

    def emb():
        return torch.from_numpy((rs.randn(V, E) * 0.01).astype(
            np.float32)).to(torch.bfloat16)
    p = {"embed": emb(), "head": emb(), "norm_scale": torch.ones(E),
         "norm1": torch.ones(L, E), "norm2": torch.ones(L, E)}
    for name, shape in (("qkv_w", (L, E, (H + 2 * Hkv) * D)),
                        ("o_w", (L, H * D, E)), ("gate_w", (L, E, F)),
                        ("up_w", (L, E, F)), ("down_w", (L, F, E))):
        p[name] = torch.from_numpy(rs.randint(-80, 80, size=shape).astype(
            np.int8))
        p[name + SCALE] = torch.full((L,), 2e-3)
    return as_serving_params(p, cfg, resolve_device(device))


def init_serving_params(cfg: LlamaConfig, seed: int = 0, device=None,
                        std=0.02):
    """Random packed LLaMA weights on ``device`` (``None`` → cuda) from a
    seeded ``torch.Generator``: N(0, std) matrices and embeddings (0.02
    is the flax init), RMSNorm scales 1. Drawn layer by layer in fp32 and
    cast, so the fp32 copy never exceeds one layer's matrix."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for name, (shape, kind) in param_shapes(cfg).items():
        if kind == "ones":
            out[name] = torch.ones(shape, dtype=torch.float32, device=dev)
            continue
        t = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for part in (t if len(shape) == 3 else [t]):
            part.copy_(torch.empty(part.shape, dtype=torch.float32,
                                   device=dev).normal_(0.0, std,
                                                       generator=gen))
        out[name] = t
    return out


def _weights(p, name, L):
    """(stack, per-layer scales) of a layer matrix: int8 codes with their
    scales, or a bf16/fp32 stack with scale 1, as JAX's ``_weights``
    gives them."""
    if p[name].dtype == torch.int8:
        return p[name], p[name + SCALE]
    return p[name], torch.ones(L, dtype=torch.float32, device=p[name].device)


def layer_weights(p, l, dtype=None):
    """Layer ``l``'s matrices [in, out] and norm scales for a dense pass:
    int8 codes dequantized as (codes.float() * s[l]).to(dtype) (the
    prefill's ``deq``, serving/adapters.py:870-875), fp matrices cast to
    ``dtype`` (default: the embeddings' dtype)."""
    dt = dtype or p["embed"].dtype
    w = {"norm1": p["norm1"][l], "norm2": p["norm2"][l]}
    for name in LAYER_MATS:
        m = p[name][l]
        if m.dtype == torch.int8:
            # one pass: int8 * fp32 computes in fp32, rounded once to dt
            w[name] = torch.mul(m, p[name + SCALE][l],
                                out=torch.empty(m.shape, dtype=dt,
                                                device=m.device))
        else:
            w[name] = m.to(dt)
    return w


def block_forward(w, cfg: LlamaConfig, x, cos, sin, attention,
                  kv_quant_from=None):
    """One LLaMA block over full sequences x [B, S, E] with layer weights
    ``w`` (``layer_weights``) — the prefill body of
    ``serving/adapters.py:877-903`` and the prompt pass of
    ``models/llama_inference.py:212-233`` (dense products in plain
    PyTorch, as JAX left them to XLA). Returns (x, k, v) with k/v [B, Hkv,
    S, D] after RoPE. With ``kv_quant_from``, the queries at that position
    and past attend over K/V rounded through the int8 cache's codes, as
    decode steps over an int8 cache do; earlier ones over K/V as they
    are, as the prefill does."""
    B, S, E = x.shape
    H, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    eps = cfg.rms_eps
    u = rms_norm(x, w["norm1"], eps)
    qkv = u @ w["qkv_w"]

    def heads(t, n):
        return t.reshape(B, S, n, D).transpose(1, 2)
    q = heads(qkv[..., :H * D], H)
    k = heads(qkv[..., H * D:(H + Hkv) * D], Hkv)
    v = heads(qkv[..., (H + Hkv) * D:], Hkv).contiguous()
    q = apply_rope(q, cos, sin).contiguous()
    k = apply_rope(k, cos, sin).contiguous()
    ctx = attention(q, k, v, causal=True)
    if kv_quant_from is not None:
        ctx_q = attention(q, fake_quant(k), fake_quant(v), causal=True)
        late = torch.arange(S, device=x.device) >= kv_quant_from
        ctx = torch.where(late[:, None], ctx_q, ctx)
    x = x + ctx.transpose(1, 2).reshape(B, S, H * D) @ w["o_w"]
    u2 = rms_norm(x, w["norm2"], eps)
    h = torch.nn.functional.silu(u2 @ w["gate_w"]) * (u2 @ w["up_w"])
    return x + h @ w["down_w"], k, v


def dense_logits(p, cfg: LlamaConfig, ids, dtype=None, kv_quant_from=None):
    """Full-sequence logits [S, V] (fp32) of ids [S] through the plain
    reference attention: the dense oracle a decode run is held against.
    ``dtype`` (default: the embeddings') is the arithmetic's; the matrices
    are dequantized or cast to it one layer at a time. For a run over an
    int8 KV cache, ``kv_quant_from`` is the prompt length: positions from
    there on (decode steps) attend over K/V rounded through the cache's
    codes, the prompt's (the prefill) over K/V as they are."""
    from deepspeed_tpu_torch.ops.attention import reference_attention
    dev = p["embed"].device
    dt = dtype or p["embed"].dtype
    ids = torch.as_tensor(ids, device=dev).long()
    S = ids.shape[0]
    cos, sin = rope_angles(torch.arange(S, device=dev), cfg.head_dim,
                           cfg.rope_theta)
    x = p["embed"][ids][None].to(dt)
    for l in range(cfg.n_layers):
        x, _, _ = block_forward(layer_weights(p, l, dt), cfg, x, cos, sin,
                                reference_attention, kv_quant_from)
    u = rms_norm(x[0], p["norm_scale"], cfg.rms_eps)
    return (u @ p["head"].to(dt).T).float()


def is_jax_tree(params) -> bool:
    """True for the JAX package's nested LLaMA trees (packed serving or
    training), not the port's flat packed dict."""
    return "blk" in params or "layers" in params


# ------------------------------------------------------------- fast loop

def _check_fast_decode(cfg: LlamaConfig, B, kv_cache_bits):
    """``_supports_fast_decode``: every packed projection width
    lane-aligned, B <= 64, kv_cache_bits 0 or 8."""
    E, H, Hkv, D = (cfg.hidden_size, cfg.n_heads, cfg.kv_heads,
                    cfg.head_dim)
    if not (kv_cache_bits in (0, 8) and B <= 64 and E % 128 == 0
            and ((H + 2 * Hkv) * D) % 128 == 0 and (H * D) % 128 == 0
            and cfg.intermediate_size % 128 == 0):
        raise ValueError(
            f"config outside the fused fast-decode envelope (B={B}, "
            f"E={E}, packed qkv width {(H + 2 * Hkv) * D}, "
            f"F={cfg.intermediate_size}, kv_cache_bits={kv_cache_bits})")


def _prompt_pass(p, cfg: LlamaConfig, ids, L_cache, cache_q8):
    """The prompt pass (``prompt``, models/llama_inference.py:179-257):
    ids [B, S] padded to a multiple of 128 (the pad rows are inert under
    the causal mask), dense products on each layer's dequantized weights,
    the flash kernel, and each layer's K/V written into the stacked cache
    [Lyr, B, Hkv, L_cache, D] without the pad rows (as int8 codes with
    per-(b, head, pos) scales when ``cache_q8``, quantized inside the
    layer loop so the fp32 transient is one layer's). Returns (last
    position's logits [B, V] in the weights' dtype, caches)."""
    dev, dt = ids.device, p["embed"].dtype
    B, S = ids.shape
    Lyr, Hkv, D = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    Sp = -(-S // 128) * 128
    x = torch.nn.functional.pad(p["embed"][ids], (0, 0, 0, Sp - S))
    cos, sin = rope_angles(torch.arange(Sp, device=dev), D, cfg.rope_theta)
    shape = (Lyr, B, Hkv, L_cache, D)
    if cache_q8:
        caches = (torch.zeros(shape, dtype=torch.int8, device=dev),
                  torch.zeros(shape[:3] + (1, L_cache), device=dev),
                  torch.zeros(shape, dtype=torch.int8, device=dev),
                  torch.zeros(shape[:3] + (1, L_cache), device=dev))
    else:
        caches = (torch.zeros(shape, dtype=dt, device=dev),
                  torch.zeros(shape, dtype=dt, device=dev))
    for l in range(Lyr):
        x, k, v = block_forward(layer_weights(p, l), cfg, x, cos, sin,
                                dot_product_attention)
        if cache_q8:
            for t, codes, scales in ((k, caches[0], caches[1]),
                                     (v, caches[2], caches[3])):
                c, sc = quantize_rows(t[:, :, :S])
                codes[l, :, :, :S] = c
                scales[l, :, :, 0, :S] = sc[..., 0]
        else:
            caches[0][l, :, :, :S] = k[:, :, :S]
            caches[1][l, :, :, :S] = v[:, :, :S]
        del k, v
    u = rms_norm(x[:, S - 1], p["norm_scale"], cfg.rms_eps)
    return u @ p["head"].T, caches


def llama_fast_generate(cfg: LlamaConfig, sparams, input_ids,
                        max_new_tokens=20, temperature: float = 0.0,
                        rng=None, max_out_tokens: int = 0,
                        kv_cache_bits: int = 0, device=None):
    """Fused-kernel generation over packed serving weights (the port's
    dict, fp or int8, or a JAX tree, carried across): the prompt pass,
    then a decode loop of the stacked kernels over a contiguous
    layer-stacked cache [Lyr, B, Hkv, max_out, D] (int8 codes and scales
    with ``kv_cache_bits=8``). Returns ids [B, S + max_new_tokens] (int64,
    on the weights' device). ``rng`` is the sampling seed (default 0): the
    port cannot reproduce jax.random's bits, so a sampled run is
    deterministic under one seed but differs from JAX's; greedy tokens
    are JAX's. ``device=None`` means cuda; pass ``device="cpu"`` to run
    the kernels' plain versions."""
    dev = resolve_device(device)
    if is_jax_tree(sparams):
        p = from_jax_serving_params(sparams, cfg, dev)
    else:
        p = as_serving_params(sparams, cfg, dev)
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).long()
    if max_new_tokens <= 0:
        return ids
    B, S = ids.shape
    total = S + max_new_tokens
    max_out = max_out_tokens or cfg.max_seq_len
    assert total <= max_out, (total, max_out)
    _check_fast_decode(cfg, B, kv_cache_bits)
    cache_q8 = kv_cache_bits == 8
    gen = torch.Generator(device=dev).manual_seed(
        0 if rng is None else int(rng))
    logits, caches = _prompt_pass(p, cfg, ids, max_out, cache_q8)
    tok = pick_token(logits, temperature, gen)
    out = [ids, tok[:, None]]
    if max_new_tokens > 1:
        out += [t[:, None] for t in _decode_loop(
            p, cfg, caches, tok, S, max_new_tokens - 1, temperature, gen)]
    return torch.cat(out, 1)


def _decode_loop(p, cfg: LlamaConfig, caches, tok, start, steps,
                 temperature, gen):
    """``fast_scan`` (models/llama_inference.py:259-347): ``steps`` decode
    steps from position ``start``; the position is a device scalar, so
    the loop does not sync to the host (except to sample). Each layer:
    ln_qkv_stacked, RoPE, decode_attention_stacked writing the new K/V
    rows into the cache first (int8 codes into an int8 cache, at
    min(offset, L - 1)), and the o-projection +
    FFN through out_ffn_stacked (with matvec_stacked first past
    ``fused_proj``). Yields each step's tokens [B]."""
    dev = tok.device
    E, H, Hkv, D = (cfg.hidden_size, cfg.n_heads, cfg.kv_heads,
                    cfg.head_dim)
    Lyr, rep, eps = cfg.n_layers, cfg.n_heads // cfg.kv_heads, cfg.rms_eps
    L_cache = caches[0].shape[3]
    cache_q8 = len(caches) == 4
    (Wq, sq), (Wo, so), (Wg, sg), (Wu, su), (Wd, sd) = (
        _weights(p, name, Lyr) for name in LAYER_MATS)
    fused = fused_proj(cfg, Wo)
    lids = torch.arange(Lyr, dtype=torch.int32, device=dev)
    offset = torch.full((1,), start, dtype=torch.int32, device=dev)
    B = tok.shape[0]
    scale = 1.0 / float(np.sqrt(D))
    nan = torch.tensor(float("nan"), dtype=p["embed"].dtype, device=dev)
    for _ in range(steps):
        x = p["embed"][tok]
        x = torch.where(offset >= L_cache, nan, x)
        cos, sin = rope_tables(offset.expand(B), D, cfg.rope_theta, x.dtype)
        for l in range(Lyr):
            lid = lids[l]
            qkv = ln_qkv_stacked(x, p["norm1"], None, Wq, sq, None, lid,
                                 eps=eps, norm="rms")
            qk = rope_rows(qkv[:, :(H + Hkv) * D].reshape(B, H + Hkv, D),
                           cos, sin)
            k3 = qk[:, H:]
            v3 = qkv[:, (H + Hkv) * D:].reshape(B, Hkv, D)
            qg = qk[:, :H].reshape(B, Hkv, rep, D).contiguous()
            # the new rows go into the cache inside the attention kernel,
            # at min(offset, L_cache - 1) as dynamic_update_slice clamps
            # the write (int8 codes and scales into an int8 cache)
            scales = {"k_scale": caches[1], "v_scale": caches[3]} \
                if cache_q8 else {}
            ctx = decode_attention_stacked(
                qg, caches[0], caches[len(caches) // 2], offset, lid,
                scale=scale, new_k=k3, new_v=v3, **scales)
            ctx = ctx.reshape(B, H * D)
            if fused:
                x = out_ffn_stacked(
                    ctx, x, Wo, so, None, p["norm2"], None, Wg, sg, None, Wd,
                    sd, None, lid, act="swiglu", eps=eps, norm="rms",
                    w1b_stack=Wu, s1b=su)
            else:
                x1 = x + matvec_stacked(ctx, Wo, so, lid)
                x = out_ffn_stacked(
                    None, x1, None, None, None, p["norm2"], None, Wg, sg,
                    None, Wd, sd, None, lid, act="swiglu", eps=eps,
                    norm="rms", w1b_stack=Wu, s1b=su, fuse_proj=False)
        logits = rms_norm(x, p["norm_scale"], eps) @ p["head"].T
        tok = pick_token(logits, temperature, gen)
        offset = offset + 1
        yield tok
