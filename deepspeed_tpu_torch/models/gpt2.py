"""GPT-2: configuration, presets, the training model and its weight bridge.

Port of ``deepspeed_tpu/models/gpt2.py``: ``GPT2Config`` (:217), the
presets (:661-681), ``SelfAttention``, ``MLP``, ``Block`` and
``GPT2LMHeadModel`` (:257-596) as ``nn.Module``s, and ``chunked_lm_loss``
/ ``lm_loss`` (:599-656). Parameters keep flax's names and ``[in, out]``
kernel orientation, so ``jax_tree`` / ``from_jax_tree`` carry a training
tree (its gradients and Adam moments too) across leaf by leaf, in the
scan-stacked ``h/blk/...`` layout or the unrolled ``h_0 .. h_{L-1}`` one.
Serving reads the layer-stacked weight dict that ``init_params`` makes and
``models/gpt2_inference.from_jax_params`` carries across.
"""

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.jax_bridge import JaxTreeBridge
from deepspeed_tpu_torch.ops import fused_collective as fc
from deepspeed_tpu_torch.ops.attention import dot_product_attention
from deepspeed_tpu_torch.ops.transformer.transformer import Dense, LayerNorm
from deepspeed_tpu_torch.utils.device import resolve_device

ROADMAP_REMAT = ("ROADMAP.md queue 1, item \"Named remat policies, "
                 "dropout and an untied LM head\"")


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    dtype: Any = torch.bfloat16       # activation/compute dtype
    tie_word_embeddings: bool = True
    # training fields
    dropout: float = 0.0
    param_dtype: Any = torch.float32  # master parameters
    remat: bool = False
    remat_policy: Optional[str] = None  # None = full block recompute
    # the JAX tree layout the bridge and checkpoints read and write
    scan_layers: bool = True
    # fused head + loss in chunks of this many tokens (no [B, S, V]); 0 = off
    loss_chunk: int = 0

    @property
    def head_dim(self):
        return self.n_embd // self.n_head

    @property
    def n_inner(self):
        return 4 * self.n_embd

    def num_params(self):
        V, P, E, L = self.vocab_size, self.n_positions, self.n_embd, \
            self.n_layer
        return V * E + P * E + L * (12 * E * E + 13 * E) + 2 * E


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


# -- the training model ------------------------------------------------------

class CollectiveDense(Dense):
    """``Dense`` whose product can fuse with the ZeRO-3 gather
    (``CollectiveDense``, ``deepspeed_tpu/models/gpt2.py:153``). Outside a
    ``gather_scope`` it is ``Dense`` exactly. Inside one (the prefetch
    pipeline's ``fused_matmul`` layers) a shard-shaped kernel is this
    rank's resting shard, and the product goes through
    ``collective_matmul``: the gather fused into the GEMM, dW through
    matmul+reduce-scatter; the bias is added after, as in JAX. A
    full-shaped kernel takes the dense path even inside a scope."""

    def __init__(self, in_dim, features, std, dtype, param_dtype,
                 device=None):
        super().__init__(in_dim, features, std, dtype, param_dtype, device)
        self.in_dim, self.features = in_dim, features

    def forward(self, x):
        cfg = fc.gather_ctx()
        if cfg is not None:
            shard_dim = fc.infer_shard_dim(self.kernel.shape, self.in_dim,
                                           self.features, cfg.axis_size)
            if shard_dim is not None:
                dt = self.dtype
                y = fc.collective_matmul(
                    x.to(dt), self.kernel.to(dt), shard_dim=shard_dim,
                    axis_size=cfg.axis_size, cfg=cfg)
                return y + self.bias.to(dt)
        return super().forward(x)


def _collective_dense(cfg, in_dim, features, std, device):
    return CollectiveDense(in_dim, features, std, cfg.dtype, cfg.param_dtype,
                           device)


def _layer_norm(cfg, device):
    return LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, cfg.dtype,
                     cfg.param_dtype, device)


class SelfAttention(nn.Module):
    """Causal self-attention. ``attention`` is the [B, H, S, D] attention
    function it calls (``ops.attention.dot_product_attention``); an
    instance may be given another with the same signature, such as a
    reference to check the kernels against."""

    attention = staticmethod(dot_product_attention)

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.n_embd
        self.c_attn = _collective_dense(cfg, E, 3 * E, 0.02, device)
        self.c_proj = _collective_dense(cfg, E, E,
                                        0.02 / math.sqrt(2 * cfg.n_layer),
                                        device)

    def forward(self, x):
        cfg = self.cfg
        B, S, E = x.shape
        q, k, v = self.c_attn(x).split(E, dim=-1)

        def heads(t):
            return t.reshape(B, S, cfg.n_head, cfg.head_dim).transpose(1, 2)
        out = self.attention(heads(q), heads(k), heads(v), causal=True)
        return self.c_proj(out.transpose(1, 2).reshape(B, S, E))


class MLP(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        E = cfg.n_embd
        self.c_fc = _collective_dense(cfg, E, 4 * E, 0.02, device)
        self.c_proj = _collective_dense(cfg, 4 * E, E,
                                        0.02 / math.sqrt(2 * cfg.n_layer),
                                        device)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Block(nn.Module):
    """Pre-LN GPT-2 block. ``keep_prob`` is progressive layer drop's keep
    probability (a float or a device scalar): x + keep * sublayer(x), keep
    cast to x's dtype (gpt2.py:336-365). At the float 1.0 the product is
    left out: x * 1 is x exactly."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln_1 = _layer_norm(cfg, device)
        self.attn = SelfAttention(cfg, device)
        self.ln_2 = _layer_norm(cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, keep_prob=1.0):
        if isinstance(keep_prob, float) and keep_prob == 1.0:
            x = x + self.attn(self.ln_1(x))
            return x + self.mlp(self.ln_2(x))
        keep = torch.as_tensor(keep_prob, device=x.device).to(x.dtype)
        x = x + keep * self.attn(self.ln_1(x))
        return x + keep * self.mlp(self.ln_2(x))


class GPT2LMHeadModel(JaxTreeBridge, nn.Module):
    """GPT-2 with its tied LM head, flax's parameter names.

    ``forward(input_ids)`` gives logits in the compute dtype;
    ``forward(input_ids, labels)`` gives the mean next-token loss, through
    ``chunked_lm_loss`` when ``cfg.loss_chunk > 0``; ``keep_prob`` is
    progressive layer drop's (``Block``). The
    parameters are made on ``device`` (default ``"meta"``: the engine
    places and initializes them, as the JAX engine calls ``model.init``);
    ``reset_parameters`` draws them from an explicit ``torch.Generator``
    with the JAX init. ``param_dtype`` other than fp32 is for the
    ZeRO-Infinity engine, which keeps its own fp32 masters; the main
    engine refuses it where it places the parameters."""

    def __init__(self, config: GPT2Config, device="meta"):
        super().__init__()
        cfg = self.config = config
        if cfg.remat_policy is not None:
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported (only "
                f"full block recompute, remat_policy=None) ({ROADMAP_REMAT})")
        if cfg.dropout > 0:
            raise NotImplementedError(
                f"dropout {cfg.dropout} is not ported ({ROADMAP_REMAT})")
        if not cfg.tie_word_embeddings:
            raise NotImplementedError(
                f"an untied LM head is not ported ({ROADMAP_REMAT})")
        E = cfg.n_embd
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, E,
                                            dtype=cfg.param_dtype,
                                            device=device))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, E,
                                            dtype=cfg.param_dtype,
                                            device=device))
        self.h = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layer))
        self.ln_f = _layer_norm(cfg, device)

    def reset_parameters(self, generator):
        """The JAX init (gpt2.py:537-540, :264-331): wte N(0, 0.02), wpe
        N(0, 0.01), c_attn/c_fc N(0, 0.02), both c_proj N(0,
        0.02/sqrt(2L)), zero biases, LayerNorm 1/0."""
        with torch.no_grad():
            self.wte.normal_(0.0, 0.02, generator=generator)
            self.wpe.normal_(0.0, 0.01, generator=generator)
        for m in self.modules():
            if isinstance(m, (Dense, LayerNorm)):
                m.reset_parameters(generator)

    def forward(self, input_ids, labels=None, keep_prob=1.0):
        cfg = self.config
        dt = cfg.dtype
        S = input_ids.shape[1]
        x = F.embedding(input_ids, self.wte).to(dt) + self.wpe[:S].to(dt)[None]
        for block in self.h:
            x = checkpoint(block, x, keep_prob, use_reentrant=False) \
                if cfg.remat else block(x, keep_prob)
        x = self.ln_f(x)
        if labels is not None and cfg.loss_chunk > 0:
            return chunked_lm_loss(x, self.wte.to(dt), labels, cfg.loss_chunk)
        logits = torch.matmul(x, self.wte.to(dt).t())
        return logits if labels is None else lm_loss(logits, labels)

    # -- the layered-apply contract of the ZeRO-3 prefetch pipeline ----------

    def block_apply(self, x, leaves, keep_prob=1.0):
        """One block over ``leaves`` ({block parameter name: tensor}, the
        names of ``prefetch_layer_leaves``) instead of its own
        parameters: the layer body of the prefetch pipeline and of the
        ZeRO-Infinity segments."""
        return torch.func.functional_call(self.h[0], leaves, (x, keep_prob))

    @property
    def prefetch_layer_subtree(self):
        """The layer-stacked subtree the engine's stage3_prefetch pipeline
        drives layer by layer ("h": the blocks), or None when the model
        offers none (gpt2.py:480: unrolled layers, dropout)."""
        cfg = self.config
        return "h" if cfg.scan_layers and cfg.dropout == 0 else None

    def prefetch_layer_leaves(self):
        """A block's parameter names, in the order the pipeline's leaves
        take (``named_parameters`` of a block)."""
        return [n for n, _ in self.h[0].named_parameters()]

    @property
    def collective_matmul_paths(self):
        """The block leaves ``CollectiveDense`` consumes (gpt2.py:512): the
        engine streams shards to these alone."""
        return ("attn.c_attn.kernel", "attn.c_proj.kernel",
                "mlp.c_fc.kernel", "mlp.c_proj.kernel")

    def prefetch_apply(self, params, input_ids, layer_scan, keep_prob=1.0,
                       labels=None):
        """``forward`` with the blocks run through ``layer_scan(body, x,
        params["h"])`` (gpt2.py:521): ``params`` holds the gathered outer
        leaves by name and, under "h", one list of leaves a layer (in
        ``prefetch_layer_leaves`` order); ``body(x, leaves)`` applies one
        block with them. The engine passes the prefetch pipeline."""
        cfg = self.config
        dt = cfg.dtype
        S = input_ids.shape[1]
        x = F.embedding(input_ids, params["wte"]).to(dt) \
            + params["wpe"][:S].to(dt)[None]
        names = self.prefetch_layer_leaves()

        def body(xc, leaves):
            return self.block_apply(xc, dict(zip(names, leaves)), keep_prob)
        x = layer_scan(body, x, params["h"])
        x = torch.func.functional_call(
            self.ln_f, {"scale": params["ln_f.scale"],
                        "bias": params["ln_f.bias"]}, (x,))
        wte = params["wte"].to(dt)
        if labels is not None and cfg.loss_chunk > 0:
            return chunked_lm_loss(x, wte, labels, cfg.loss_chunk)
        logits = torch.matmul(x, wte.t())
        return logits if labels is None else lm_loss(logits, labels)

    # -- the weight bridge ---------------------------------------------------

    def jax_paths(self, scan_layers=None):
        """{port parameter name: (JAX tree path, layer or None)}: the
        layer of a scan-stacked leaf ``h/blk/...``, None for a leaf of its
        own (``wte``, ``h_3/...``)."""
        scan = self.config.scan_layers if scan_layers is None else scan_layers
        out = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            if parts[0] == "h":
                layer, rest = int(parts[1]), tuple(parts[2:])
                out[name] = (("h", "blk") + rest, layer) if scan \
                    else ((f"h_{layer}",) + rest, None)
            else:
                out[name] = (tuple(parts), None)
        return out

    @staticmethod
    def scan_tree(tree):
        return "h" in tree


def _chunk_nll(h, t, wte, ignore_index):
    logits = torch.matmul(h, wte.t()).float()            # [C, V]
    valid = t != ignore_index
    t0 = torch.where(valid, t, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    g = logits.gather(1, t0[:, None])[:, 0]
    return (torch.where(valid, lse - g, 0.0).sum(),
            valid.sum(dtype=torch.int32))


def chunked_lm_loss(hidden, wte, labels, chunk, ignore_index=-100):
    """Fused LM head + next-token cross entropy without a [B, S, V]
    buffer: chunks of ``chunk`` tokens project to [C, V] and reduce to
    their nll at once; each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``, as ``@jax.checkpoint`` at gpt2.py:622).
    Equals ``lm_loss(logits, labels)`` to fp32 rounding."""
    B, S, E = hidden.shape
    xs = hidden[:, :-1, :].reshape(-1, E)
    tgt = labels[:, 1:].reshape(-1)
    n = xs.shape[0]
    pad = (-n) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        tgt = F.pad(tgt, (0, pad), value=ignore_index)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c in range(0, n + pad, chunk):
        ds, dc = checkpoint(_chunk_nll, xs[c:c + chunk], tgt[c:c + chunk],
                            wte, ignore_index, use_reentrant=False)
        total, count = total + ds, count + dc
    return total / count.clamp_min(1)


def lm_loss(logits, labels, ignore_index=-100):
    """Next-token cross entropy in fp32 on UNSHIFTED labels (the shift
    happens here: logits[:, :-1] vs labels[:, 1:])."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    valid = targets != ignore_index
    targets = torch.where(valid, targets, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    nll = torch.where(valid, lse - tgt, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)
