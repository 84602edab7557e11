"""Flash-attention forward: the CUDA kernel (csrc/flash_attention.cu) and
its plain PyTorch version.

Replaces ``deepspeed_tpu/ops/pallas/flash_attention.py:580``
``flash_attention`` (forward: ``_flash_fwd`` :149, ``_fwd_kernel`` :122).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. The backward waits for the training slice.
"""

import math

import torch

from deepspeed_tpu_torch.ops.cuda import builder

NEG_INF = -1e30
HEAD_DIM = 64     # the kernel's head dim (GPT-2's)
ROADMAP_FLASH = ("ROADMAP.md queue 2, item \"flash attention: other head "
                 "dims, fp32 and the backward\"")


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """(o, lse) for [B, H, S, D] q and [B, Hkv, S, D] k/v: the kernel's
    arithmetic in plain PyTorch — fp32 scores and softmax, p rounded to
    v's dtype before the V product (as ``_fwd_block_step`` does), o in
    q's dtype, lse [B, H, S] fp32. K/V heads map to q heads by index."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """(o, lse) — see flash_attention_fwd_plain. On CUDA: bf16,
    contiguous [B, H, S, 64] q and [B, Hkv, S, 64] k/v with H % Hkv == 0."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    B, H, S, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[2] != S or k.shape[3] != D:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"flash_attention_fwd: {H} q heads are not a "
                         f"multiple of {Hkv} kv heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}")
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"flash_attention_fwd: the CUDA kernel takes bf16, got "
                f"{name} {t.dtype} ({ROADMAP_FLASH})")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"contiguous")
    if D != HEAD_DIM:
        raise NotImplementedError(
            f"flash_attention_fwd: the CUDA kernel takes head dim "
            f"{HEAD_DIM}, got {D} ({ROADMAP_FLASH})")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    lib = builder.kernels()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if S == 0:
        return o, lse
    lib.call("dstpu_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), lse.data_ptr(), B * H, H, Hkv, S, scale,
             int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    builder.launches["flash_attention_fwd"] += 1
    return o, lse


def flash_attention(q, k, v, causal=False, scale=None):
    """[B, H, S, D] flash attention forward (the output only)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
