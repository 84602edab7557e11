"""LLaMA serving weights: the packed layout, the weight bridge, seeded
weights and a dense forward.

Port of ``deepspeed_tpu/models/llama_inference.py`` (packing :14-18,
``convert_llama_serving_params`` :42, ``_weights`` :117). The serving
weights are one flat dict of layer-stacked tensors, packed as the JAX
serving tree packs them::

    qkv_w [L, E, (H + 2*Hkv) * D]   (q | k | v column blocks)
    o_w   [L, H*D, E]   gate_w, up_w [L, E, F]   down_w [L, F, E]
    norm1, norm2 [L, E]; embed [V, E]; head [V, E]; norm_scale [E]

Matrices keep flax's ``[in, out]`` orientation, so the decode kernels
read ``W[l]`` as ``[E, N]`` exactly as the TPU kernels do. Matrices and
embeddings are in ``cfg.dtype``, the RMSNorm scales in fp32. int8 codes
(``kernel_q``) are not ported.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import ROADMAP_INT8
from deepspeed_tpu_torch.models.llama import (LlamaConfig, apply_rope,
                                              rms_norm, rope_angles)
from deepspeed_tpu_torch.utils.device import resolve_device

# packed name → the training tree's (sub-block, leaf) under layers/blk
_MATS = {"o_w": ("attn", "o_proj"), "gate_w": ("mlp", "gate_proj"),
         "up_w": ("mlp", "up_proj"), "down_w": ("mlp", "down_proj")}
_LAYER_MATS = ("qkv_w",) + tuple(_MATS)


def param_shapes(cfg: LlamaConfig):
    """{name: (shape, kind)} of the packed serving weights; kind is
    "normal" (a matrix or embedding) or "ones" (an RMSNorm scale)."""
    E, F, L, V = (cfg.hidden_size, cfg.intermediate_size, cfg.n_layers,
                  cfg.vocab_size)
    H, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    return {
        "embed": ((V, E), "normal"), "head": ((V, E), "normal"),
        "norm_scale": ((E,), "ones"),
        "qkv_w": ((L, E, (H + 2 * Hkv) * D), "normal"),
        "o_w": ((L, H * D, E), "normal"),
        "gate_w": ((L, E, F), "normal"), "up_w": ((L, E, F), "normal"),
        "down_w": ((L, F, E), "normal"),
        "norm1": ((L, E), "ones"), "norm2": ((L, E), "ones"),
    }


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
    """A JAX LLaMA tree (the packed serving tree, or the scan-stacked
    training tree, which is packed first) → the port's packed tensors on
    ``device``. An int8 tree (``kernel_q``) raises: it is never
    dequantized silently."""
    if "layers" in tree:
        tree = convert_llama_serving_params(tree, cfg)
    blk = tree["blk"]
    if any(isinstance(sub, dict) and "kernel_q" in sub
           for sub in blk.values()):
        raise NotImplementedError(
            f"int8 LLaMA serving trees (kernel_q) are not ported "
            f"({ROADMAP_INT8})")
    arrays = {"embed": tree["embed"], "head": tree["head"],
              "norm_scale": tree["norm_scale"], "norm1": blk["norm1"],
              "norm2": blk["norm2"]}
    for name in _LAYER_MATS:
        arrays[name] = blk[name]["kernel"]
    return as_serving_params(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in arrays.items()}, cfg, device)


def as_serving_params(params, cfg: LlamaConfig, device):
    """Check a packed weight dict against ``cfg`` and place it on
    ``device``: matrices and embeddings in cfg.dtype, RMSNorm scales in
    fp32."""
    out = {}
    for name, (shape, kind) in param_shapes(cfg).items():
        t = params[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"LLaMA weight {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        dtype = cfg.dtype if kind == "normal" else torch.float32
        out[name] = t.to(device=device, dtype=dtype).contiguous()
    return out


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
    """(stack, per-layer scales) of a weight: the bf16/fp32 stacks run
    the kernels with scale 1, as JAX's ``_weights`` gives them."""
    return p[name], torch.ones(L, dtype=torch.float32,
                               device=p[name].device)


def block_forward(p, cfg: LlamaConfig, l, x, cos, sin, attention):
    """One LLaMA block over a full sequence x [1, S, E] — the prefill body
    of ``serving/adapters.py:877-903`` (dense products in plain PyTorch,
    as JAX left them to XLA). Returns (x, k, v) with k/v [1, Hkv, S, D]
    after RoPE."""
    _, S, E = x.shape
    H, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    eps = cfg.rms_eps
    u = rms_norm(x, p["norm1"][l], eps)
    qkv = u @ p["qkv_w"][l]

    def heads(t, n):
        return t.reshape(1, S, n, D).transpose(1, 2)
    q = heads(qkv[..., :H * D], H)
    k = heads(qkv[..., H * D:(H + Hkv) * D], Hkv)
    v = heads(qkv[..., (H + Hkv) * D:], Hkv).contiguous()
    q = apply_rope(q, cos, sin).contiguous()
    k = apply_rope(k, cos, sin).contiguous()
    ctx = attention(q, k, v, causal=True)
    x = x + ctx.transpose(1, 2).reshape(1, S, H * D) @ p["o_w"][l]
    u2 = rms_norm(x, p["norm2"][l], eps)
    h = torch.nn.functional.silu(u2 @ p["gate_w"][l]) * (u2 @ p["up_w"][l])
    return x + h @ p["down_w"][l], k, v


def dense_logits(p, cfg: LlamaConfig, ids, dtype=None):
    """Full-sequence logits [S, V] (fp32) of ids [S] through the plain
    reference attention: the dense oracle a paged run is held against.
    ``dtype`` (default: the weights') is the arithmetic's; the matrices
    are cast to it one layer at a time."""
    from deepspeed_tpu_torch.ops.attention import reference_attention
    dev = p["embed"].device
    dt = dtype or p["embed"].dtype
    ids = torch.as_tensor(ids, device=dev).long()
    S = ids.shape[0]
    cos, sin = rope_angles(torch.arange(S, device=dev), cfg.head_dim,
                           cfg.rope_theta)
    x = p["embed"][ids][None].to(dt)
    for l in range(cfg.n_layers):
        pl = {k: p[k][l:l + 1].to(dt) for k in _LAYER_MATS}
        pl.update(norm1=p["norm1"][l:l + 1], norm2=p["norm2"][l:l + 1])
        x, _, _ = block_forward(pl, cfg, 0, x, cos, sin, reference_attention)
    u = rms_norm(x[0], p["norm_scale"], cfg.rms_eps)
    return (u @ p["head"].to(dt).T).float()


def is_jax_tree(params) -> bool:
    """True for the JAX package's nested LLaMA trees (packed serving or
    training), not the port's flat packed dict."""
    return "blk" in params or "layers" in params
