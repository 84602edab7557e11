"""GPT-2 serving: the weights carried across from the JAX trees, the fused
inference model, int8 weights, ``generate()`` and a dense forward.

Port of ``deepspeed_tpu/models/gpt2_inference.py``: ``inference_config``
(:30), ``GPT2InferenceModel`` (:66), ``_convert_block`` /
``convert_gpt2_params`` (:113, :133), ``quantize_gpt2_inference_params``
(:230), ``_supports_fast_decode`` (:286), the stacked fast loop
``_fast_decode_scan_fn`` (:301) and ``generate`` (:449). The
tensor-parallel pieces (``mesh``, ``gpt2_inference_tp_specs``,
``shard_inference_params``) are not ported.

The port's serving weights are one flat dict of layer-stacked tensors
(``models/gpt2.param_shapes``, and ``lm_head`` [E, V] for an untied head).
Matrices keep flax's ``[in, out]`` orientation, so the decode kernels read
``W[l]`` as ``[E, N]`` exactly as the TPU kernels do. Quantized (JAX's
``kernel_q``), each of the four layer matrices is int8 codes with
``<name>_scale`` [L, groups, 1] fp32 scales.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.models.gpt2 import GPT2Config, param_shapes
from deepspeed_tpu_torch.ops.cuda.decode import (MAX_SLOTS,
                                                 ROADMAP_DECODE_VARIANTS,
                                                 decode_attention_stacked,
                                                 fake_quant, kv_quant_int8,
                                                 ln_qkv_stacked,
                                                 out_ffn_stacked)
from deepspeed_tpu_torch.ops.transformer.inference import (
    SCALE, WEIGHTS, DeepSpeedInferenceConfig, DeepSpeedTransformerInference,
    KVCache, dequantize, layer_norm, quantize_weight)
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.sampling import pick_token

# port name → (inference-tree sub-block, leaf); the training tree's
# block names map onto the inference ones as in _convert_block
_STACKS = {
    "ln1_w": ("attn_nw", "scale"), "ln1_b": ("attn_nw", "bias"),
    "attn_qkvw": ("attn_qkvw", "kernel"), "attn_qkvb": ("attn_qkvw", "bias"),
    "attn_ow": ("attn_ow", "kernel"), "attn_ob": ("attn_ow", "bias"),
    "ln2_w": ("norm_w", "scale"), "ln2_b": ("norm_w", "bias"),
    "inter_w": ("inter_w", "kernel"), "inter_b": ("inter_w", "bias"),
    "output_w": ("output_w", "kernel"), "output_b": ("output_w", "bias"),
}
_TRAIN_BLOCK = {"attn_nw": ("ln_1",), "attn_qkvw": ("attn", "c_attn"),
                "attn_ow": ("attn", "c_proj"), "norm_w": ("ln_2",),
                "inter_w": ("mlp", "c_fc"), "output_w": ("mlp", "c_proj")}
# the per-layer tensors a layer's weights dict holds
LAYER_KEYS = tuple(_STACKS)


def _np(a):
    """numpy copy of a leaf: int8 codes stay int8, the rest fp32."""
    a = np.asarray(a)
    return np.array(a, dtype=np.int8 if a.dtype == np.int8 else np.float32)


def _block_leaves(blk):
    """{inference sub-block: {leaf: array}} from a training or an
    inference block."""
    if "moe" in blk:
        raise NotImplementedError("MoE GPT-2 blocks are not ported")
    if "attn_qkvw" in blk:
        return blk
    out = {}
    for sub, path in _TRAIN_BLOCK.items():
        node = blk
        for key in path:
            node = node[key]
        out[sub] = node
    return out


def _leaves(blk):
    """port name → (sub-block, leaf) of a block: int8 blocks carry
    ``kernel_q`` and ``kernel_scale`` where fp ones carry ``kernel``."""
    leaves = dict(_STACKS)
    kinds = {"kernel_q" in blk[name] for name in WEIGHTS}
    if len(kinds) > 1:
        raise ValueError("a GPT-2 tree quantizes all four layer matrices or "
                         "none")
    if kinds == {True}:
        for name in WEIGHTS:
            leaves[name] = (name, "kernel_q")
            leaves[name + SCALE] = (name, "kernel_scale")
    return leaves


def from_jax_params(tree, cfg: GPT2Config, device):
    """The JAX GPT-2 tree (nested dicts of numpy-convertible arrays) →
    the port's stacked tensors on ``device``. Takes the training tree in
    the scan-stacked ``h/blk/...`` layout or the unrolled ``h_0 ..
    h_{L-1}`` layout, or the converted inference tree, fp or int8
    (``kernel_q`` + ``kernel_scale``: the codes stay int8)."""
    if "h" in tree:
        blk = _block_leaves(tree["h"]["blk"])

        def stack(sub, leaf):
            return _np(blk[sub][leaf])
    else:
        blocks = [_block_leaves(tree[f"h_{i}"]) for i in range(cfg.n_layer)]
        blk = blocks[0]

        def stack(sub, leaf):
            return np.stack([_np(b[sub][leaf]) for b in blocks])
    leaves = _leaves(blk)
    arrays = {"wte": _np(tree["wte"]), "wpe": _np(tree["wpe"]),
              "ln_f_w": _np(tree["ln_f"]["scale"]),
              "ln_f_b": _np(tree["ln_f"]["bias"])}
    if not cfg.tie_word_embeddings:
        arrays["lm_head"] = _np(tree["lm_head"]["kernel"])
    for name, (sub, leaf) in leaves.items():
        arrays[name] = stack(sub, leaf)
    return as_serving_params(
        {k: torch.from_numpy(v) for k, v in arrays.items()}, cfg, device)


def is_int8(p) -> bool:
    """True for weights whose layer matrices are int8 codes."""
    return p["attn_qkvw"].dtype == torch.int8


def inference_shapes(cfg: GPT2Config, int8=False, groups=1):
    """{name: (shape, kind)} of the serving weights: ``param_shapes``, the
    untied head ``lm_head`` [E, V] (kind "normal"), and with ``int8`` the
    four layer matrices as "codes" with their "scale" [L, groups, 1]."""
    out = dict(param_shapes(cfg))
    if not cfg.tie_word_embeddings:
        out["lm_head"] = ((cfg.n_embd, cfg.vocab_size), "normal")
    if int8:
        for name in WEIGHTS:
            out[name] = (out[name][0], "codes")
            out[name + SCALE] = ((cfg.n_layer, groups, 1), "scale")
    return out


def as_serving_params(params, cfg: GPT2Config, device):
    """Check a stacked weight dict against ``cfg`` and place it on
    ``device``: matrices and embeddings in cfg.dtype, int8 codes as int8,
    LayerNorm parameters, biases and code scales in fp32."""
    int8 = is_int8(params)
    groups = params["attn_qkvw" + SCALE].shape[1] if int8 else 1
    out = {}
    for name, (shape, kind) in inference_shapes(cfg, int8, groups).items():
        if name not in params:
            raise ValueError(f"GPT-2 weight {name} is missing")
        t = params[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"GPT-2 weight {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if kind in ("codes", "normal") and name in WEIGHTS \
                and (kind == "codes") != (t.dtype == torch.int8):
            raise ValueError(f"GPT-2 weight {name} is {t.dtype}: the layer "
                             f"matrices are all int8 codes or none")
        dtype = {"normal": cfg.dtype, "codes": torch.int8}.get(
            kind, torch.float32)
        out[name] = t.to(device=device, dtype=dtype).contiguous()
    return out


def quantize_gpt2_inference_params(p, groups: int = 1):
    """Serving weights → int8 codes with ``groups`` scales a layer matrix
    (``quantize_gpt2_inference_params``, through
    ``ops.transformer.inference.quantize_weight``): each of the four layer
    matrices becomes codes and ``<name>_scale`` [L, groups, 1];
    embeddings, LayerNorms and biases are kept as they are."""
    out = {k: v for k, v in p.items() if k not in WEIGHTS}
    for name in WEIGHTS:
        out[name], out[name + SCALE] = quantize_weight(p[name], groups)
    return out


def weight_stack(p, name):
    """(stack, per-layer scales [L]) of a layer matrix as the stacked
    kernels take it: int8 codes with their scales (one group a layer), or
    a bf16/fp32 stack with scale 1, as JAX's ``_wscale`` gives them."""
    w = p[name]
    L = w.shape[0]
    if w.dtype != torch.int8:
        return w, torch.ones(L, dtype=torch.float32, device=w.device)
    s = p[name + SCALE]
    if s.shape[1] != 1:
        raise ValueError(f"{name}: the stacked kernels take one scale a "
                         f"layer (quantize_groups 1), got {s.shape[1]}")
    return w, s.reshape(L)


def layer_matrix(p, name, l, dtype=None):
    """Layer l's matrix [in, out] in ``dtype`` (default: the embeddings'):
    int8 codes dequantized as (codes · scale) in fp32, rounded once, as
    the prefill's ``deq`` (serving/adapters.py:358-362) and
    ``QuantDense`` do."""
    dt = dtype or p["wte"].dtype
    w = p[name][l]
    if w.dtype == torch.int8:
        return dequantize(w, p[name + SCALE][l], dt)
    return w.to(dt)


def layer_params(p, l):
    """Layer l's weights as the inference layer takes them: views of the
    stacks (and of the codes' scales)."""
    keys = LAYER_KEYS + tuple(n + SCALE for n in WEIGHTS if n + SCALE in p)
    return {k: p[k][l] for k in keys}


def block_forward(p, cfg: GPT2Config, l, x, attention, dtype=None,
                  kv_quant_from=None):
    """One pre-LN GPT-2 block over full sequences x [B, S, E] — the
    prefill body of ``serving/adapters.py:418`` (dense products in plain
    PyTorch on layer l's matrices, dequantized if int8, in ``dtype``
    (default: the embeddings'), as JAX left them to XLA). Returns (x, k,
    v) with k/v [B, H, S, D]. With ``kv_quant_from``, the queries at that
    position and past attend over K/V rounded through the int8 cache's
    codes, as decode steps over an int8 cache do."""
    dt = dtype or p["wte"].dtype
    B, S, E = x.shape
    H, D = cfg.n_head, cfg.head_dim
    eps = cfg.layer_norm_epsilon

    def mat(name):
        return layer_matrix(p, name, l, dt)
    u = layer_norm(x, p["ln1_w"][l], p["ln1_b"][l], eps)
    qkv = u @ mat("attn_qkvw") + p["attn_qkvb"][l].to(dt)

    def heads(t):
        return t.reshape(B, S, H, D).transpose(1, 2).contiguous()
    q, k, v = (heads(qkv[..., i * E:(i + 1) * E]) for i in range(3))
    ctx = attention(q, k, v, causal=True)
    if kv_quant_from is not None:
        ctx_q = attention(q, fake_quant(k), fake_quant(v), causal=True)
        late = torch.arange(S, device=x.device) >= kv_quant_from
        ctx = torch.where(late[:, None], ctx_q, ctx)
    ctx = ctx.transpose(1, 2).reshape(B, S, E)
    x = x + ctx @ mat("attn_ow") + p["attn_ob"][l].to(dt)
    u2 = layer_norm(x, p["ln2_w"][l], p["ln2_b"][l], eps)
    h = torch.nn.functional.gelu(
        u2 @ mat("inter_w") + p["inter_b"][l].to(dt), approximate="tanh")
    x = x + h @ mat("output_w") + p["output_b"][l].to(dt)
    return x, k, v


def dense_logits(p, cfg: GPT2Config, ids, dtype=None, kv_quant_from=None):
    """Full-sequence logits [S, V] (fp32) of ids [S] through the plain
    reference attention: the dense oracle a decode run is held against.
    ``dtype`` (default: the embeddings') is the arithmetic's; int8 codes
    are dequantized one layer at a time. For a run over an int8 KV cache,
    ``kv_quant_from`` is the first position that attends over K/V rounded
    through the cache's codes: the prompt length for the paged engine
    (its prefill attends over K/V as they are), 0 for ``generate`` (its
    prompt pass already reads the codes)."""
    from deepspeed_tpu_torch.ops.attention import reference_attention
    dt = dtype or p["wte"].dtype
    ids = torch.as_tensor(ids, device=p["wte"].device).long()
    S = ids.shape[0]
    x = (p["wte"][ids] + p["wpe"][:S])[None].to(dt)
    for l in range(cfg.n_layer):
        x, _, _ = block_forward(p, cfg, l, x, reference_attention, dt,
                                kv_quant_from)
    u = layer_norm(x[0], p["ln_f_w"], p["ln_f_b"], cfg.layer_norm_epsilon)
    head = p["wte"].T if cfg.tie_word_embeddings else p["lm_head"]
    return (u @ head.to(dt)).float()


def is_jax_tree(params) -> bool:
    """True for the JAX package's nested-dict layouts (not the port's
    flat stacked dict)."""
    return "attn_qkvw" not in params


# ------------------------------------------------------- the fused model

def inference_config(cfg: GPT2Config, max_out_tokens: int = 0, dtype=None,
                     quantize_bits: int = 0, quantize_groups: int = 1,
                     kv_cache_bits: int = 0) -> DeepSpeedInferenceConfig:
    """The inference layer's config for GPT-2: pre-LN, causal, tanh GELU,
    a cache of ``max_out_tokens`` (default n_positions)."""
    return DeepSpeedInferenceConfig(
        hidden_size=cfg.n_embd, heads=cfg.n_head,
        layer_norm_eps=cfg.layer_norm_epsilon, pre_layer_norm=True,
        triangular_masking=True,
        max_out_tokens=max_out_tokens or cfg.n_positions,
        gelu_approximate=True, quantize_bits=quantize_bits,
        quantize_groups=quantize_groups, kv_cache_bits=kv_cache_bits,
        dtype=dtype or cfg.dtype)


class GPT2InferenceModel(torch.nn.Module):
    """GPT-2 LM on the fused inference layer over the port's stacked
    serving weights ``p`` (``as_serving_params``; int8 codes with
    ``quantize_bits=8``). ``forward(input_ids [B, S], cache=None,
    position_offset=0, last_only=False)`` → logits [B, S, V] (the last
    position's alone with ``last_only``): embeddings ``wte[ids] +
    wpe[pos]``, every layer over its cache, ``ln_f``, the tied ``wte`` or
    the untied ``lm_head``. ``position_offset`` is a number or a
    one-element int32 tensor on the device; the cache's index advances by
    S after the layers."""

    def __init__(self, cfg: GPT2Config, p, max_out_tokens: int = 0,
                 quantize_bits: int = 0, quantize_groups: int = 1,
                 kv_cache_bits: int = 0):
        super().__init__()
        self.cfg, self.p = cfg, p
        self.icfg = inference_config(cfg, max_out_tokens,
                                     quantize_bits=quantize_bits,
                                     quantize_groups=quantize_groups,
                                     kv_cache_bits=kv_cache_bits)
        self.layer = DeepSpeedTransformerInference(self.icfg)
        self._layers = [layer_params(p, l) for l in range(cfg.n_layer)]

    def make_cache(self, batch) -> KVCache:
        cfg = self.cfg
        return KVCache.zeros(cfg.n_layer, batch, cfg.n_head,
                             self.icfg.max_out_tokens, cfg.head_dim,
                             self.icfg.compute_dtype,
                             self.icfg.kv_cache_bits, self.p["wte"].device)

    def forward(self, input_ids, cache=None, position_offset=0,
                last_only=False):
        cfg, p = self.cfg, self.p
        dt = self.icfg.compute_dtype
        S = input_ids.shape[1]
        # past the table the gather clamps, as JAX's does
        pos = (position_offset + torch.arange(S, device=input_ids.device)
               ).clamp(max=cfg.n_positions - 1)
        x = p["wte"][input_ids].to(dt) + p["wpe"][pos][None].to(dt)
        for l, w in enumerate(self._layers):
            x = self.layer(x, w, None if cache is None else cache.layer(l))
        if cache is not None:
            cache.advance(S)
        if last_only:
            x = x[:, -1:]
        x = layer_norm(x, p["ln_f_w"], p["ln_f_b"], cfg.layer_norm_epsilon)
        head = p["wte"].T if cfg.tie_word_embeddings else p["lm_head"]
        return x @ head.to(dt)


def _supports_fast_decode(cfg: GPT2Config, B, quantize_bits,
                          quantize_groups, kv_cache_bits, mp_size=1):
    """Gate for the stacked fast loop (``_supports_fast_decode``,
    gpt2_inference.py:286), condition for condition; the port's config
    has no MoE (its ``moe_experts == 0`` holds)."""
    return (quantize_bits in (0, 8) and kv_cache_bits in (0, 8)
            and (quantize_bits == 0 or quantize_groups == 1)
            and mp_size == 1 and B <= 64
            and cfg.n_embd % 128 == 0 and (4 * cfg.n_embd) % 128 == 0
            and cfg.scan_layers and cfg.tie_word_embeddings)


def weight_stacks(p):
    """The four layer matrices (qkv, o-projection, up, down) as
    ``weight_stack`` gives them to the stacked kernels."""
    return tuple(weight_stack(p, n) for n in WEIGHTS)


def decode_layer(p, cfg: GPT2Config, w, x, l, lid, attend):
    """Layer ``l`` (device index ``lid``) of one decode step over the
    stacked kernels, shared by ``generate``'s fast loop and the paged
    engine's tick: ln_qkv_stacked; then ``attend(l, lid, q [B, H, 1, D],
    k [B, H, D], v [B, H, D])``, which writes the new K/V rows into its
    cache and returns the context [B, H, 1, D]; then out_ffn_stacked.
    ``w``: ``weight_stacks(p)``. Returns x [B, E]."""
    E, H, D = cfg.n_embd, cfg.n_head, cfg.head_dim
    eps = cfg.layer_norm_epsilon
    B = x.shape[0]
    (Wq, sq), (Wp, sp), (W1, s1), (W2, s2) = w
    qkv = ln_qkv_stacked(x, p["ln1_w"], p["ln1_b"], Wq, sq, p["attn_qkvb"],
                         lid, eps=eps)
    ctx = attend(l, lid, qkv[:, :E].reshape(B, H, 1, D).contiguous(),
                 qkv[:, E:2 * E].view(B, H, D), qkv[:, 2 * E:].view(B, H, D))
    return out_ffn_stacked(
        ctx.reshape(B, E), x, Wp, sp, p["attn_ob"], p["ln2_w"], p["ln2_b"],
        W1, s1, p["inter_b"], W2, s2, p["output_b"], lid, act="gelu_tanh",
        eps=eps)


def _fast_decode(p, cfg: GPT2Config, cache: KVCache, tok, start, steps,
                 temperature, gen):
    """The stacked fast loop (``_fast_decode_scan_fn``,
    gpt2_inference.py:301-446): ``steps`` decode steps from position
    ``start`` over the layer-stacked cache; the position is a device
    scalar, so the loop does not sync to the host (except to sample).
    Each layer is ``decode_layer``, whose attention writes the new K/V
    rows into the cache (kv_quant_int8 into an int8 one) and runs
    decode_attention_stacked. Yields each step's tokens [B]."""
    dev = tok.device
    L_cache = cache.length
    w = weight_stacks(p)
    stacks = cache.stacks()
    lids = torch.arange(cfg.n_layer, dtype=torch.int32, device=dev)
    offset = torch.full((1,), start, dtype=torch.int32, device=dev)
    scale = 1.0 / float(np.sqrt(cfg.head_dim))
    nan = torch.tensor(float("nan"), dtype=p["wte"].dtype, device=dev)

    def attend(l, lid, qh, k3, v3):         # at this step's row and offset
        if cache.q8:
            kv_quant_int8(k3, v3, out=stacks, layer=lid, rows=row)
            return decode_attention_stacked(
                qh, stacks[0], stacks[2], offset, lid, k_scale=stacks[1],
                v_scale=stacks[3], scale=scale)
        cache.k[l].index_copy_(2, row.long(), k3[:, :, None])
        cache.v[l].index_copy_(2, row.long(), v3[:, :, None])
        return decode_attention_stacked(qh, cache.k, cache.v, offset, lid,
                                        scale=scale)
    for _ in range(steps):
        x = p["wte"][tok] + p["wpe"][offset.clamp(
            max=cfg.n_positions - 1).long()]
        # overflow: a clamped row write would serve stale context; poison
        x = torch.where(offset >= L_cache, nan, x)
        row = offset.clamp(max=L_cache - 1)
        for l in range(cfg.n_layer):
            x = decode_layer(p, cfg, w, x, l, lids[l], attend)
        logits = layer_norm(x, p["ln_f_w"], p["ln_f_b"],
                            cfg.layer_norm_epsilon) @ p["wte"].T
        tok = pick_token(logits, temperature, gen)
        offset = offset + 1
        yield tok


def serving_params(params, cfg: GPT2Config, device, quantize_bits=0,
                   quantize_groups=1):
    """The weights ``generate`` serves: the port's dict or a JAX tree,
    carried across, and held to ``quantize_bits``/``quantize_groups``
    (int8 codes come from ``quantize_gpt2_inference_params``)."""
    if is_jax_tree(params):
        p = from_jax_params(params, cfg, device)
    else:
        p = as_serving_params(params, cfg, device)
    if is_int8(p) != (quantize_bits == 8):
        raise ValueError(
            f"quantize_bits={quantize_bits} but the layer matrices are "
            f"{p['attn_qkvw'].dtype}: int8 serving takes the codes of "
            f"quantize_gpt2_inference_params, fp serving fp weights")
    if quantize_bits == 8 and p["attn_qkvw" + SCALE].shape[1] \
            != quantize_groups:
        raise ValueError(f"quantize_groups={quantize_groups} but the codes "
                         f"have {p['attn_qkvw' + SCALE].shape[1]} groups")
    return p


def generate(cfg: GPT2Config, params, input_ids, max_new_tokens=20,
             temperature: float = 0.0, generator=None,
             max_out_tokens: int = 0, quantize_bits: int = 0,
             quantize_groups: int = 1, kv_cache_bits: int = 0,
             scan_decode: bool = True, device=None):
    """KV-cache generation (``generate``, gpt2_inference.py:449). Returns
    ids [B, S + max_new_tokens] (int64, on the weights' device);
    ``temperature == 0`` is greedy, otherwise tokens are sampled with
    ``generator`` (a ``torch.Generator`` on the device; default seeded
    0). jax.random's bits cannot be reproduced: a sampled run is
    deterministic under one generator seed but differs from JAX's; greedy
    tokens are JAX's.

    The prompt pass fills the cache; the decode steps then take JAX's
    routes: with ``scan_decode`` and ``_supports_fast_decode`` the
    stacked fast loop, otherwise a per-token loop of
    ``GPT2InferenceModel`` steps (JAX's ``decode_scan`` and step loop,
    which PyTorch has no compiled scan to tell apart), whose layers take
    the fused int8 step or the general path. ``quantize_bits=8`` serves
    int8 codes (``quantize_gpt2_inference_params``); ``kv_cache_bits=8``
    an int8 cache. ``device=None`` means cuda; pass ``device="cpu"`` to
    run the kernels' plain versions."""
    dev = resolve_device(device)
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).long()
    B, S = ids.shape
    total = S + max_new_tokens
    # every emitted position needs a real learned position embedding
    assert total <= cfg.n_positions, (
        f"prompt {S} + max_new_tokens {max_new_tokens} exceeds "
        f"n_positions {cfg.n_positions}")
    max_out = max_out_tokens or cfg.n_positions
    assert total <= max_out, (total, max_out)
    p = serving_params(params, cfg, dev, quantize_bits, quantize_groups)
    if max_new_tokens <= 0:
        return ids
    model = GPT2InferenceModel(cfg, p, max_out, quantize_bits,
                               quantize_groups, kv_cache_bits)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    cache = model.make_cache(B)
    logits = model(ids, cache, last_only=True)[:, -1]
    tok = pick_token(logits, temperature, gen)
    out = [ids, tok[:, None]]
    if scan_decode and max_new_tokens > 1 and _supports_fast_decode(
            cfg, B, quantize_bits, quantize_groups, kv_cache_bits):
        if dev.type == "cuda" and B > MAX_SLOTS:
            raise NotImplementedError(
                f"the stacked decode kernels take at most {MAX_SLOTS} rows, "
                f"got B={B} ({ROADMAP_DECODE_VARIANTS})")
        out += [t[:, None] for t in _fast_decode(
            p, cfg, cache, tok, S, max_new_tokens - 1, temperature, gen)]
        return torch.cat(out, 1)
    offset = torch.full((1,), S, dtype=torch.int32, device=dev)
    for _ in range(max_new_tokens - 1):
        logits = model(tok[:, None], cache, position_offset=offset)[:, -1]
        tok = pick_token(logits, temperature, gen)
        out.append(tok[:, None])
        offset = offset + 1
    return torch.cat(out, 1)
