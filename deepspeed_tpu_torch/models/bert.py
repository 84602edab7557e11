"""BERT: configuration, presets, the models, their losses and the weight
bridge.

Port of ``deepspeed_tpu/models/bert.py``: ``BertConfig`` (:28) with
``num_params``, ``BertEmbeddings``, ``BertEncoder`` (the fused training
layer of ``ops/transformer/transformer.py``), ``BertModel``,
``BertForPreTraining`` (MLM decoder tied to ``word_embeddings``, plus
``mlm_bias``), ``BertForQuestionAnswering``,
``BertForSequenceClassification``, ``mlm_loss``, ``pretraining_loss`` and
the presets. A ``sparsity_config`` on the config
(``SparseAttentionUtils.sparse_config_for``) routes every layer's
attention through the block-sparse kernels.

Parameters keep flax's names and ``[in, out]`` kernels, so ``jax_tree`` /
``from_jax_tree`` carry a training tree (its gradients and Adam moments
too) across leaf by leaf, in the unrolled layout
``bert/encoder/DeepSpeedTransformerLayer_{i}/...`` or the
``scan_layers=True`` stacked one ``bert/encoder/layer/
DeepSpeedTransformerLayer_0/...``.
"""

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.jax_bridge import JaxTreeBridge
from deepspeed_tpu_torch.ops.transformer.transformer import (
    ROADMAP_REMAT, DeepSpeedTransformerConfig, Dense, LayerNorm,
    transformer_layer)

SCAN_LAYER = "DeepSpeedTransformerLayer_0"   # the scanned layer's name


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = False       # modeling.py vs modelingpreln.py
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # the JAX tree layout the bridge and checkpoints read and write
    scan_layers: bool = False
    # fused-layer memory knobs (not ported: the layer raises)
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    attn_dropout_checkpoint: bool = False
    # block-sparse attention layout (SparseAttentionUtils.sparse_config_for)
    sparsity_config: Any = None

    def transformer_config(self) -> DeepSpeedTransformerConfig:
        return DeepSpeedTransformerConfig(
            sparsity_config=self.sparsity_config,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            heads=self.num_attention_heads,
            attn_dropout_ratio=self.attention_probs_dropout_prob,
            hidden_dropout_ratio=self.hidden_dropout_prob,
            num_hidden_layers=self.num_hidden_layers,
            initializer_range=self.initializer_range,
            layer_norm_eps=self.layer_norm_eps,
            pre_layer_norm=self.pre_layer_norm,
            normalize_invertible=self.normalize_invertible,
            gelu_checkpoint=self.gelu_checkpoint,
            attn_dropout_checkpoint=self.attn_dropout_checkpoint,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
        )

    def num_params(self):
        E, L, F_ = self.hidden_size, self.num_hidden_layers, \
            self.intermediate_size
        emb = (self.vocab_size + self.max_position_embeddings
               + self.type_vocab_size) * E + 2 * E
        per_layer = 4 * E * E + 2 * E * F_ + 9 * E + F_
        final_ln = 2 * E if self.pre_layer_norm else 0
        return emb + L * per_layer + final_ln + E * E + E


def bert_tiny(**kw):
    base = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=128,
                max_position_embeddings=128)
    base.update(kw)
    return BertConfig(**base)


def bert_base(**kw):
    return BertConfig(**kw)


def bert_large(**kw):
    base = dict(hidden_size=1024, num_hidden_layers=24,
                num_attention_heads=16, intermediate_size=4096)
    base.update(kw)
    return BertConfig(**base)


def _no_dropout_in_training(p, deterministic):
    if p > 0 and not deterministic:
        raise NotImplementedError(f"dropout {p} in training is not ported "
                                  f"({ROADMAP_REMAT})")


class BertEmbeddings(nn.Module):
    def __init__(self, cfg, device="meta"):
        super().__init__()
        self.cfg = cfg
        E, pdt = cfg.hidden_size, cfg.param_dtype
        for name, rows in (("word_embeddings", cfg.vocab_size),
                           ("position_embeddings",
                            cfg.max_position_embeddings),
                           ("token_type_embeddings", cfg.type_vocab_size)):
            setattr(self, name, nn.Parameter(torch.empty(
                rows, E, dtype=pdt, device=device)))
        self.LayerNorm = LayerNorm(E, cfg.layer_norm_eps, cfg.dtype, pdt,
                                   device)

    def reset_parameters(self, generator):
        with torch.no_grad():
            for t in (self.word_embeddings, self.position_embeddings,
                      self.token_type_embeddings):
                t.normal_(0.0, self.cfg.initializer_range,
                          generator=generator)
        self.LayerNorm.reset_parameters()

    def forward(self, input_ids, token_type_ids=None, deterministic=True):
        _no_dropout_in_training(self.cfg.hidden_dropout_prob, deterministic)
        S = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = F.embedding(input_ids, self.word_embeddings) \
            + self.position_embeddings[:S][None] \
            + F.embedding(token_type_ids, self.token_type_embeddings)
        return self.LayerNorm(x.to(self.cfg.dtype))


class BertEncoder(nn.Module):
    def __init__(self, cfg, device="meta"):
        super().__init__()
        self.layer = nn.ModuleList(
            transformer_layer(cfg.transformer_config(), device)
            for _ in range(cfg.num_hidden_layers))
        if cfg.pre_layer_norm:   # pre-LN stacks end with a final normalize
            self.FinalLayerNorm = LayerNorm(cfg.hidden_size,
                                            cfg.layer_norm_eps, cfg.dtype,
                                            cfg.param_dtype, device)

    def forward(self, x, attention_mask=None, deterministic=True):
        for layer in self.layer:
            x = layer(x, attention_mask, deterministic)
        if hasattr(self, "FinalLayerNorm"):
            x = self.FinalLayerNorm(x)
        return x


class _BertBridge(JaxTreeBridge, nn.Module):
    """What the BERT models share: the seeded init and the weight bridge
    to the JAX tree (a bare ``BertModel``'s is ``embeddings/...``)."""

    def reset_parameters(self, generator):
        """The JAX init from ``generator``: embeddings and the
        ``initializer_range`` kernels N(0, 0.02) (the layers' output
        projections / sqrt(2L)), flax's default lecun normal for the
        small heads, zero biases and ``mlm_bias``, LayerNorm 1/0."""
        for m in self.modules():
            if isinstance(m, (BertEmbeddings, Dense, LayerNorm)):
                m.reset_parameters(generator)
        if hasattr(self, "mlm_bias"):
            with torch.no_grad():
                self.mlm_bias.zero_()

    def jax_paths(self, scan_layers=None):
        """{port parameter name: (JAX tree path, layer or None)}: the
        layer of a scan-stacked leaf ``.../encoder/layer/
        DeepSpeedTransformerLayer_0/...``, None for a leaf of its own."""
        scan = self.config.scan_layers if scan_layers is None \
            else scan_layers
        out = {}
        for name, _ in self.named_parameters():
            parts = tuple(name.split("."))
            if "layer" in parts:
                i = parts.index("layer")
                head, layer, rest = parts[:i], int(parts[i + 1]), \
                    parts[i + 2:]
                out[name] = (head + ("layer", SCAN_LAYER) + rest, layer) \
                    if scan else \
                    (head + (f"DeepSpeedTransformerLayer_{layer}",) + rest,
                     None)
            else:
                out[name] = (parts, None)
        return out

    @staticmethod
    def scan_tree(tree):
        encoder = tree["bert"]["encoder"] if "bert" in tree \
            else tree["encoder"]
        return "layer" in encoder


class BertModel(_BertBridge):
    """Embeddings → fused encoder stack → pooler; ``forward`` returns
    (sequence_output [B, S, E], pooled_output [B, E])."""

    def __init__(self, config: BertConfig, device="meta"):
        super().__init__()
        cfg = self.config = config
        if cfg.param_dtype != torch.float32:
            raise NotImplementedError("BERT keeps fp32 master parameters "
                                      "(param_dtype=float32)")
        self.embeddings = BertEmbeddings(cfg, device)
        self.encoder = BertEncoder(cfg, device)
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size,
                            cfg.initializer_range, cfg.dtype,
                            cfg.param_dtype, device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic=True):
        x = self.embeddings(input_ids, token_type_ids, deterministic)
        x = self.encoder(x, attention_mask, deterministic)
        return x, torch.tanh(self.pooler(x[:, 0]))


class BertForPreTraining(_BertBridge):
    """MLM + NSP heads; ``forward`` returns (prediction_logits [B, S, V]
    in the compute dtype, seq_relationship_logits [B, 2]). The MLM decoder
    is the word-embedding table itself (tied) plus ``mlm_bias``."""

    def __init__(self, config: BertConfig, device="meta"):
        super().__init__()
        cfg = self.config = config
        E, dt, pdt = cfg.hidden_size, cfg.dtype, cfg.param_dtype
        self.bert = BertModel(cfg, device)
        self.transform = Dense(E, E, cfg.initializer_range, dt, pdt, device)
        self.transform_ln = LayerNorm(E, cfg.layer_norm_eps, dt, pdt, device)
        self.seq_relationship = Dense(E, 2, None, dt, pdt, device)
        self.mlm_bias = nn.Parameter(torch.empty(cfg.vocab_size, dtype=pdt,
                                                 device=device))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic=True):
        dt = self.config.dtype
        seq_out, pooled = self.bert(input_ids, attention_mask,
                                    token_type_ids, deterministic)
        h = self.transform_ln(F.gelu(self.transform(seq_out)))
        word = self.bert.embeddings.word_embeddings
        mlm_logits = torch.matmul(h, word.to(dt).t()) + self.mlm_bias.to(dt)
        return mlm_logits, self.seq_relationship(pooled)


class BertForQuestionAnswering(_BertBridge):
    """SQuAD head: (start_logits, end_logits) [B, S], in fp32."""

    def __init__(self, config: BertConfig, device="meta"):
        super().__init__()
        cfg = self.config = config
        self.bert = BertModel(cfg, device)
        self.qa_outputs = Dense(cfg.hidden_size, 2, None, torch.float32,
                                cfg.param_dtype, device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic=True):
        seq_out, _ = self.bert(input_ids, attention_mask, token_type_ids,
                               deterministic)
        logits = self.qa_outputs(seq_out.float())
        return logits[..., 0], logits[..., 1]


class BertForSequenceClassification(_BertBridge):
    """Classifier over the pooled output: logits [B, num_labels], fp32."""

    def __init__(self, config: BertConfig, num_labels=2, device="meta"):
        super().__init__()
        cfg = self.config = config
        self.bert = BertModel(cfg, device)
        self.classifier = Dense(cfg.hidden_size, num_labels, None,
                                torch.float32, cfg.param_dtype, device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic=True):
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              deterministic)
        return self.classifier(pooled.float())


def mlm_loss(mlm_logits, labels, ignore_index=-100):
    """Masked-LM cross entropy in fp32 over positions where labels !=
    ignore_index."""
    logits = mlm_logits.float()
    valid = labels != ignore_index
    targets = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    ll = torch.where(valid, ll, 0.0)
    return -ll.sum() / valid.sum().clamp_min(1)


def pretraining_loss(outputs, batch):
    """MLM + NSP loss from a batch dict with ``mlm_labels`` (and optional
    ``nsp_labels``)."""
    mlm_logits, nsp_logits = outputs
    loss = mlm_loss(mlm_logits, batch["mlm_labels"])
    if "nsp_labels" in batch:
        nsp = torch.log_softmax(nsp_logits.float(), dim=-1)
        loss = loss - nsp.gather(
            -1, batch["nsp_labels"].long()[:, None])[:, 0].mean()
    return loss
