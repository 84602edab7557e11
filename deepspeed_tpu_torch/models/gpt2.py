"""GPT-2 configuration, presets and seeded random weights.

Port of ``deepspeed_tpu/models/gpt2.py:217`` ``GPT2Config`` and the
presets at ``:661-681``. The training model waits for the training
slice; serving reads the layer-stacked weight dict that ``init_params``
makes and ``models/gpt2_inference.from_jax_params`` carries across.
"""

import dataclasses
from typing import Any

import torch

from deepspeed_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    dtype: Any = torch.bfloat16       # weight and activation dtype
    tie_word_embeddings: bool = True

    @property
    def head_dim(self):
        return self.n_embd // self.n_head

    @property
    def n_inner(self):
        return 4 * self.n_embd


def gpt2_tiny(**kw):
    base = dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2,
                n_head=2)
    base.update(kw)
    return GPT2Config(**base)


def gpt2_small(**kw):
    return GPT2Config(n_embd=768, n_layer=12, n_head=12, **kw)


def gpt2_medium(**kw):
    return GPT2Config(n_embd=1024, n_layer=24, n_head=16, **kw)


def gpt2_large(**kw):
    return GPT2Config(n_embd=1280, n_layer=36, n_head=20, **kw)


def gpt2_xl(**kw):
    return GPT2Config(n_embd=1600, n_layer=48, n_head=25, **kw)


# name → (shape given cfg, init): "normal" draws N(0, 0.02), "ones" and
# "zeros" are LayerNorm scales and biases. Matrices and embeddings are
# stored in cfg.dtype; LayerNorm parameters and biases stay fp32, as the
# JAX decode tick reads them.
def param_shapes(cfg: GPT2Config):
    V, P, E, L, Fd = (cfg.vocab_size, cfg.n_positions, cfg.n_embd,
                      cfg.n_layer, cfg.n_inner)
    return {
        "wte": ((V, E), "normal"), "wpe": ((P, E), "normal"),
        "ln_f_w": ((E,), "ones"), "ln_f_b": ((E,), "zeros"),
        "ln1_w": ((L, E), "ones"), "ln1_b": ((L, E), "zeros"),
        "attn_qkvw": ((L, E, 3 * E), "normal"),
        "attn_qkvb": ((L, 3 * E), "zeros"),
        "attn_ow": ((L, E, E), "normal"), "attn_ob": ((L, E), "zeros"),
        "ln2_w": ((L, E), "ones"), "ln2_b": ((L, E), "zeros"),
        "inter_w": ((L, E, Fd), "normal"), "inter_b": ((L, Fd), "zeros"),
        "output_w": ((L, Fd, E), "normal"), "output_b": ((L, E), "zeros"),
    }


def init_params(cfg: GPT2Config, seed: int = 0, device=None):
    """Random GPT-2 weights from a seeded ``torch.Generator`` on
    ``device`` (``None`` → cuda): N(0, 0.02) matrices and embeddings,
    LayerNorm scale 1 and bias 0, zero biases. Returns the stacked dict
    the serving adapter takes."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for name, (shape, kind) in param_shapes(cfg).items():
        if kind == "normal":
            t = torch.empty(shape, dtype=torch.float32, device=dev)
            t.normal_(0.0, 0.02, generator=gen)
            out[name] = t.to(cfg.dtype)
        elif kind == "ones":
            out[name] = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
    return out
