"""LLaMA: configuration, presets, RoPE and RMSNorm.

Port of ``deepspeed_tpu/models/llama.py``: ``LlamaConfig`` (:41), the
presets ``llama_tiny`` (:429), ``llama_7b`` (:437) and ``llama3_8b``
(:444), ``rope_angles`` (:92), ``apply_rope`` (:100) and the RMSNorm
arithmetic (:77-89); ``rope_tables``/``rope_rows`` rotate the decode
ticks' single rows. Serving reads the packed layer-stacked weights of
``models/llama_inference.py``; the training model (``LlamaForCausalLM``)
is not ported yet.
"""

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 0              # 0 → MHA (= n_heads); < n_heads → GQA
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16      # activation/compute dtype
    # the JAX training tree's layout (``layers/blk/...`` when True)
    scan_layers: bool = True

    @property
    def kv_heads(self):
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.n_heads

    def num_params(self):
        E, F, L, V = (self.hidden_size, self.intermediate_size,
                      self.n_layers, self.vocab_size)
        Dkv = self.kv_heads * self.head_dim
        per_layer = E * E + 2 * E * Dkv + E * E + 3 * E * F + 2 * E
        return 2 * V * E + L * per_layer + E


def llama_tiny(**over):
    kw = dict(vocab_size=512, hidden_size=128, intermediate_size=352,
              n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=128,
              dtype=torch.float32)
    kw.update(over)
    return LlamaConfig(**kw)


def llama_7b(**over):
    kw = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
              n_layers=32, n_heads=32, max_seq_len=2048)
    kw.update(over)
    return LlamaConfig(**kw)


def llama3_8b(**over):
    kw = dict(vocab_size=128256, hidden_size=4096,
              intermediate_size=14336, n_layers=32, n_heads=32,
              n_kv_heads=8, max_seq_len=8192, rope_theta=500000.0)
    kw.update(over)
    return LlamaConfig(**kw)


def rope_angles(positions, head_dim, theta):
    """[S] positions → (cos, sin) [S, head_dim // 2] fp32."""
    dev = positions.device
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=dev) / head_dim))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Rotary embedding on [B, H, S, D], split-halves convention, with
    cos/sin cast to x's dtype before the products (as JAX does)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, None].to(x.dtype)
    s = sin[None, None].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rope_tables(pos, D, theta, dtype):
    """RoPE tables [B, 1, D] in ``dtype`` at per-row positions ``pos`` [B],
    made once a decode step for every layer: (cos | cos) and (-sin | sin)
    of ``rope_angles``, cast to the rows' dtype as JAX casts them."""
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=pos.device) / D))
    ang = pos.float()[:, None, None] * inv                # [B, 1, D//2]
    cos, sin = torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def rope_rows(x, cos2, sin2):
    """RoPE on [B, Hx, D] rows (split halves x1 | x2) with ``rope_tables``:
    x * (cos | cos) + (x2 | x1) * (-sin | sin) rounds where JAX's (x1*cos -
    x2*sin | x2*cos + x1*sin) does, bit for bit (the decode ticks'
    ``_rope_rows`` of serving/adapters.py:692 and ``_rope_one`` of
    models/llama_inference.py:130)."""
    half = x.shape[-1] // 2
    return x * cos2 + torch.cat([x[..., half:], x[..., :half]], -1) * sin2


def rms_norm(x, w, eps):
    """RMSNorm with fp32 statistics, the result in x's dtype."""
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)
