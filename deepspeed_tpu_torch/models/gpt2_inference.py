"""GPT-2 serving weights: carried across from the JAX trees.

Port of ``deepspeed_tpu/models/gpt2_inference.py:113,133``
(``_convert_block`` / ``convert_gpt2_params``). The port's serving
weights are one flat dict of layer-stacked tensors (see
``models/gpt2.param_shapes``). Matrices keep flax's ``[in, out]``
orientation, so the decode kernels read ``W[l]`` as ``[E, N]`` exactly
as the TPU kernels do.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import ROADMAP_INT8
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, param_shapes

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


def _np32(a):
    return np.array(a, dtype=np.float32)


def _block_leaves(blk):
    """{inference sub-block: {leaf: array}} from a training or an
    inference block."""
    if "moe" in blk:
        raise NotImplementedError("MoE GPT-2 blocks are not ported")
    if "attn_qkvw" in blk:
        if "kernel_q" in blk["attn_qkvw"]:
            raise NotImplementedError(
                f"int8 GPT-2 serving trees are not ported ({ROADMAP_INT8})")
        return blk
    out = {}
    for sub, path in _TRAIN_BLOCK.items():
        node = blk
        for key in path:
            node = node[key]
        out[sub] = node
    return out


def from_jax_params(tree, cfg: GPT2Config, device):
    """The JAX GPT-2 tree (nested dicts of numpy-convertible arrays) →
    the port's stacked tensors on ``device``. Takes the training tree in
    the scan-stacked ``h/blk/...`` layout or the unrolled ``h_0 ..
    h_{L-1}`` layout, or the converted inference tree."""
    if not cfg.tie_word_embeddings or "lm_head" in tree:
        raise NotImplementedError("paged GPT-2 serving assumes the "
                                  "tied-embedding LM head")
    if "h" in tree:
        blk = _block_leaves(tree["h"]["blk"])

        def stack(sub, leaf):
            return _np32(blk[sub][leaf])
    else:
        blocks = [_block_leaves(tree[f"h_{i}"]) for i in range(cfg.n_layer)]

        def stack(sub, leaf):
            return np.stack([_np32(b[sub][leaf]) for b in blocks])
    arrays = {"wte": _np32(tree["wte"]), "wpe": _np32(tree["wpe"]),
              "ln_f_w": _np32(tree["ln_f"]["scale"]),
              "ln_f_b": _np32(tree["ln_f"]["bias"])}
    for name, (sub, leaf) in _STACKS.items():
        arrays[name] = stack(sub, leaf)
    return as_serving_params(
        {k: torch.from_numpy(v) for k, v in arrays.items()}, cfg, device)


def as_serving_params(params, cfg: GPT2Config, device):
    """Check a stacked weight dict against ``cfg`` and place it on
    ``device``: matrices and embeddings in cfg.dtype, LayerNorm
    parameters and biases in fp32."""
    out = {}
    for name, (shape, kind) in param_shapes(cfg).items():
        t = params[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"GPT-2 weight {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        dtype = cfg.dtype if kind == "normal" else torch.float32
        out[name] = t.to(device=device, dtype=dtype).contiguous()
    return out


def layer_norm(x, w, b, eps):
    """fp32 LayerNorm, result in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def block_forward(p, cfg: GPT2Config, l, x, attention):
    """One pre-LN GPT-2 block over a full sequence x [1, S, E] — the
    prefill body of ``serving/adapters.py:418`` (dense products in
    plain PyTorch, as JAX left them to XLA). Returns (x, k, v) with k/v
    [1, H, S, D]."""
    dt = cfg.dtype
    _, S, E = x.shape
    H, D = cfg.n_head, cfg.head_dim
    eps = cfg.layer_norm_epsilon
    u = layer_norm(x, p["ln1_w"][l], p["ln1_b"][l], eps)
    qkv = u @ p["attn_qkvw"][l] + p["attn_qkvb"][l].to(dt)

    def heads(t):
        return t.reshape(1, S, H, D).transpose(1, 2).contiguous()
    q, k, v = (heads(qkv[..., i * E:(i + 1) * E]) for i in range(3))
    ctx = attention(q, k, v, causal=True)
    ctx = ctx.transpose(1, 2).reshape(1, S, E)
    x = x + ctx @ p["attn_ow"][l] + p["attn_ob"][l].to(dt)
    u2 = layer_norm(x, p["ln2_w"][l], p["ln2_b"][l], eps)
    h = torch.nn.functional.gelu(
        u2 @ p["inter_w"][l] + p["inter_b"][l].to(dt), approximate="tanh")
    x = x + h @ p["output_w"][l] + p["output_b"][l].to(dt)
    return x, k, v


def dense_logits(p, cfg: GPT2Config, ids):
    """Full-sequence logits [S, V] (fp32) of ids [S] through the plain
    reference attention: the dense oracle a paged run is held against."""
    from deepspeed_tpu_torch.ops.attention import reference_attention
    ids = torch.as_tensor(ids, device=p["wte"].device).long()
    S = ids.shape[0]
    x = (p["wte"][ids] + p["wpe"][:S])[None]
    for l in range(cfg.n_layer):
        x, _, _ = block_forward(p, cfg, l, x, reference_attention)
    u = layer_norm(x[0], p["ln_f_w"], p["ln_f_b"], cfg.layer_norm_epsilon)
    return (u @ p["wte"].T).float()


def is_jax_tree(params) -> bool:
    """True for the JAX package's nested-dict layouts (not the port's
    flat stacked dict)."""
    return "attn_qkvw" not in params
