"""ZeRO-Infinity on one card: segment-streamed training of a GPT-2 whose
parameters and optimizer state are larger than the card.

Port of ``deepspeed_tpu/runtime/zero/infinity.py``. The state rests in
host memory, page-locked on CUDA (``pinned.py``), one unit a layer row
plus one for the embeddings and ``ln_f``; a unit's fp32 master, fp32
``exp_avg_sq`` and ``exp_avg`` (in ``moment_dtype``) lie back to back
(``_Layout``), so one copy moves its whole state. A step:

1. the embedding unit comes to the card (one copy), its compute copy is
   cast in ``param_dtype``, and the tokens are embedded;
2. forward, segment by segment under ``no_grad``: a segment's fp32
   master rows come to the card, are cast to ``param_dtype`` and its
   blocks run; the K+1 boundary activations are kept;
3. the loss of the tied head (``chunked_lm_loss`` when ``loss_chunk``)
   and its gradients;
4. backward, segment by segment in reverse: the segment's whole state
   comes to the card (one copy), the masters are cast again, the
   segment is re-run with grad from its boundary (this is the
   rematerialization: the blocks inside are not checkpointed) and its
   gradient taken; then each row is updated on the card with the device
   optimizer's arithmetic (``FusedAdam._step_group`` over the row as one
   flat tensor, which is JAX's ``_row_update`` op for op) and copied
   back to the host;
5. the tied ``wte`` gradient summed in fp32 (head + embedding), and the
   embedding unit's update and copy back.

Three streams carry it on the card: a copy stream brings segment k+1's
state while segment k computes (two device sets, ordered by events), the
compute stream, and a second copy stream takes each row's updated state
back as soon as its update is done. The next step's first copy waits
for the last one back. On the CPU the same code runs on plain tensors,
the streams and events standing aside.

The compute-dtype parameters rest on NVMe when ``nvme_path`` is given
(``PartitionedParamSwapper``, durable, sub-directory
``infinity_params``: files JAX's engine reads and writes too): written
at init from the given tree, refreshed by ``park_to_nvme`` (every step
while the parameters are at most ``park_threshold_bytes``), and read
back by a fresh engine with ``restore_params=True`` (the moments
restart at zero).

``gpt2_client_init`` draws JAX's numpy init bit for bit;
``tiled_gpt2_init`` is the bench's tiled one, whose layer stacks are
broadcast views, for multi-billion-parameter models.
"""

import logging
import math
import os
import shutil
import time

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.gpt2 import (GPT2LMHeadModel,
                                             chunked_lm_loss, lm_loss)
from deepspeed_tpu_torch.ops.adam import FusedAdam
from deepspeed_tpu_torch.ops.native import aio as aio_lib
from deepspeed_tpu_torch.runtime.zero.pinned import PinnedBuffer, _on
from deepspeed_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("deepspeed_tpu_torch")

PARK_THRESHOLD_BYTES = 256 * 1024 * 1024


def block_leaves(cfg):
    """(JAX path under ``h/blk``, one layer's shape) of a GPT-2 block's
    leaves, in JAX's flatten order; the port's block parameter name is
    the path joined by dots."""
    E, Fd = cfg.n_embd, cfg.n_inner
    return [(("attn", "c_attn", "bias"), (3 * E,)),
            (("attn", "c_attn", "kernel"), (E, 3 * E)),
            (("attn", "c_proj", "bias"), (E,)),
            (("attn", "c_proj", "kernel"), (E, E)),
            (("ln_1", "bias"), (E,)), (("ln_1", "scale"), (E,)),
            (("ln_2", "bias"), (E,)), (("ln_2", "scale"), (E,)),
            (("mlp", "c_fc", "bias"), (Fd,)),
            (("mlp", "c_fc", "kernel"), (E, Fd)),
            (("mlp", "c_proj", "bias"), (E,)),
            (("mlp", "c_proj", "kernel"), (Fd, E))]


def embedding_leaves(cfg):
    """The leaves outside the blocks, in JAX's flatten order."""
    E = cfg.n_embd
    return [(("ln_f", "bias"), (E,)), (("ln_f", "scale"), (E,)),
            (("wpe",), (cfg.n_positions, E)),
            (("wte",), (cfg.vocab_size, E))]


def tree_leaves(cfg):
    """(path, shape) of every leaf of the scan-stacked JAX training tree
    of ``cfg`` (``h/blk`` stacks), in JAX's flatten order (keys sorted at
    each level)."""
    if not (cfg.scan_layers and cfg.tie_word_embeddings):
        raise ValueError("InfinityEngine streams the scan-stacked "
                         "tied-embedding GPT-2 (scan_layers=True, "
                         "tie_word_embeddings=True)")
    L = cfg.n_layer
    blk = [(("h", "blk") + p, (L,) + s) for p, s in block_leaves(cfg)]
    return sorted(blk + embedding_leaves(cfg))


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _tensor(x):
    """A CPU tensor of a numpy array (bfloat16 from ml_dtypes included)
    or a tensor."""
    if torch.is_tensor(x):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _param(a, dtype):
    # through fp32, as numpy and ml_dtypes round a float64 draw
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.float32) \
        .to(dtype)


def gpt2_client_init(cfg, seed=0):
    """The JAX package's client-side init (``infinity.py:63``), bit for
    bit: one ``np.random.RandomState(seed)`` drawn in the tree's flatten
    order, kernels N(0, 1) / sqrt(fan_in), ``wte`` N(0, 0.02), ``wpe``
    N(0, 0.01), LayerNorm scales 1, the rest 0; leaves in
    ``cfg.param_dtype``, as the JAX tree (nested dict, CPU tensors)."""
    rs = np.random.RandomState(seed)
    tree = {}
    for path, shape in tree_leaves(cfg):
        last = path[-1]
        if last == "kernel":
            a = rs.standard_normal(shape).astype(np.float32) \
                / np.sqrt(shape[-2])
        elif last == "wte":
            a = rs.standard_normal(shape).astype(np.float32) * 0.02
        elif last == "wpe":
            a = rs.standard_normal(shape).astype(np.float32) * 0.01
        elif last == "scale":
            a = np.ones(shape, np.float32)
        else:
            a = np.zeros(shape, np.float32)
        _set(tree, path, _param(a, cfg.param_dtype))
    return tree


def tiled_gpt2_init(cfg, seed=0):
    """bench.py's ``tiled_gpt2_init`` (bench.py:1339): every stacked
    [L, ...] kernel is one random layer broadcast over the L layers (an
    ``expand`` view: no memory for the stack), N(0, 1) / sqrt(fan_in);
    ``wte`` and ``wpe`` N(0, 0.02); LayerNorm scales 1, the rest 0. The
    same draws as the JAX function, in ``cfg.param_dtype``."""
    rs = np.random.RandomState(seed)
    tree = {}
    for path, shape in tree_leaves(cfg):
        last = path[-1]
        if len(shape) == 3:
            one = rs.standard_normal(shape[1:]).astype(np.float32) \
                / np.sqrt(max(shape[-2], 1)) if last == "kernel" \
                else np.zeros(shape[1:], np.float32)
            t = _param(one, cfg.param_dtype).expand(shape)
        elif last in ("wte", "wpe"):
            t = _param(rs.standard_normal(shape).astype(np.float32) * 0.02,
                       cfg.param_dtype)
        elif last == "scale":
            t = torch.ones(shape, dtype=cfg.param_dtype)
        else:
            t = torch.zeros(shape, dtype=cfg.param_dtype)
        _set(tree, path, t)
    return tree


class _Layout:
    """Where each leaf of a unit (a layer row, or the embeddings) lies in
    the unit's flat buffers: element offsets aligned to 64, the unit
    padded to ``n``, a multiple of 256 elements. The unit's state is one
    byte range of ``nbytes``: fp32 master, fp32 exp_avg_sq, then
    exp_avg in ``mdtype``. Padding stays zero through every update."""

    def __init__(self, shapes, mdtype):
        self.shapes = [tuple(s) for s in shapes]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.offsets, off = [], 0
        for size in self.sizes:
            self.offsets.append(off)
            off += -(-size // 64) * 64
        self.n = max(256, -(-off // 256) * 256)
        self.mdtype = mdtype
        msize = torch.empty((), dtype=mdtype).element_size()
        self.nbytes = self.n * (8 + msize)
        ends = self.offsets[1:] + [self.n]
        self._split = []          # leaf, gap, leaf, gap, ...
        for o, size, end in zip(self.offsets, self.sizes, ends):
            self._split += [size, end - o - size]

    def sections(self, raw):
        """(master, exp_avg_sq, exp_avg) flat views of a unit's bytes."""
        n = self.n
        return (raw[:4 * n].view(torch.float32),
                raw[4 * n:8 * n].view(torch.float32),
                raw[8 * n:self.nbytes].view(self.mdtype))

    def leaves(self, flat):
        """The leaves' views of a flat unit buffer, through one
        ``split_with_sizes``: under autograd its backward is one
        concatenation into the unit's flat gradient."""
        parts = flat.split_with_sizes(self._split)
        return [parts[2 * i].view(s) for i, s in enumerate(self.shapes)]


class InfinityEngine:
    """Segment-streamed ZeRO-Infinity trainer for scan-stacked GPT-2
    with tied embeddings. ``train_batch({"input_ids", "labels"?})``
    returns the loss as a float. ``params`` is the JAX training tree
    (``h/blk/...`` stacks, ``wte``, ``wpe``, ``ln_f``; numpy or torch,
    any float dtype); it may be None with ``restore_params``."""

    # the initialize() return tuple
    optimizer = None
    training_dataloader = None
    lr_scheduler = None

    def __init__(self, model_cfg, params=None, device=None, *,
                 segments=4, nvme_path=None, lr=1e-4, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=0.0, adam_w=True,
                 moment_dtype=torch.bfloat16,
                 park_threshold_bytes=PARK_THRESHOLD_BYTES,
                 restore_params=False, aio_config=None):
        cfg = model_cfg
        tree_leaves(cfg)          # the layout this engine streams, or raise
        if segments < 1 or cfg.n_layer % segments:
            raise ValueError(f"stream_segments {segments} must divide "
                             f"n_layer {cfg.n_layer}")
        if params is None and not restore_params:
            raise ValueError("InfinityEngine needs params unless it "
                             "restores them from nvme_path")
        if restore_params and not nvme_path:
            raise ValueError("restore_params needs nvme_path")
        if isinstance(moment_dtype, str):
            moment_dtype = torch.bfloat16 if moment_dtype == "bf16" \
                else torch.float32
        self.cfg = cfg
        self.K = segments
        self.rows = cfg.n_layer // segments
        self.lr = lr
        self.step_count = 0
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        # a meta model lends its first block's modules to every row
        self.model = GPT2LMHeadModel(cfg)
        self._adam = FusedAdam(
            lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            adam_w_mode=adam_w,
            moment_dtype="bf16" if moment_dtype == torch.bfloat16
            else "fp32")
        self._blk = block_leaves(cfg)
        self._names = [".".join(p) for p, _ in self._blk]
        self._emb = embedding_leaves(cfg)
        self._row = _Layout([s for _, s in self._blk], moment_dtype)
        self._emb_lay = _Layout([s for _, s in self._emb], moment_dtype)
        L, nb = cfg.n_layer, self._row.nbytes
        pdt_size = torch.empty((), dtype=cfg.param_dtype).element_size()
        self.param_bytes = pdt_size * (
            L * sum(self._row.sizes) + sum(self._emb_lay.sizes))

        self._host = PinnedBuffer(L * nb + self._emb_lay.nbytes,
                                  torch.uint8, self.cuda)
        self.init_s = {"pin_touch_s": self._host.touch_s,
                       "pin_register_s": self._host.register_s}
        if params is not None:
            t0 = time.perf_counter()
            self._fill(params)
            self.init_s["fill_s"] = time.perf_counter() - t0

        dev = self.device
        self._sets = [torch.empty(self.rows * nb, dtype=torch.uint8,
                                  device=dev) for _ in range(2)]
        self._pbuf = torch.empty(self.rows * self._row.n,
                                 dtype=cfg.param_dtype, device=dev)
        self._emb_dev = torch.empty(self._emb_lay.nbytes, dtype=torch.uint8,
                                    device=dev)
        self._emb_p = torch.empty(self._emb_lay.n, dtype=cfg.param_dtype,
                                  device=dev)
        self.step_marks = None
        if self.cuda:
            self._h2d, self._d2h = (torch.cuda.Stream(dev) for _ in range(2))
            self._loaded = [torch.cuda.Event() for _ in range(2)]
            self._free = [torch.cuda.Event() for _ in range(2)]
            self._emb_free = torch.cuda.Event()
        else:
            self._h2d = self._d2h = None

        self._swapper = None
        self._park_threshold = park_threshold_bytes
        if nvme_path:
            from deepspeed_tpu_torch.runtime.swap_tensor.swapper import \
                PartitionedParamSwapper
            # durable: one training run's files under a stable name, as
            # a checkpoint directory; release() reclaims them
            self._swapper = PartitionedParamSwapper(
                nvme_path, aio_config, sub_dir="infinity_params",
                durable=True)
            t0 = time.perf_counter()
            if restore_params:
                self._swapper.load_meta()
                self.restore_from_nvme()
                self.init_s["restore_s"] = time.perf_counter() - t0
            else:
                self._swapper.write_all(self._leaves_to_write(
                    lambda i: _tensor(_get(params, self._emb[i][0])),
                    lambda i, r: _tensor(_get(
                        params, ("h", "blk") + self._blk[i][0]))[r]))
                self.init_s["write_s"] = time.perf_counter() - t0
        logger.info(
            f"InfinityEngine: {L} layers in {segments} segments of "
            f"{self.rows}; {self.param_bytes / 2**30:.2f} GiB of compute "
            f"parameters, {self._host.nbytes / 1e9:.1f} GB of state in "
            f"{'pinned ' if self.cuda else ''}host memory; NVMe at-rest "
            f"tier {'on' if self._swapper else 'off'}")

    # -- the host state ----------------------------------------------------
    def _host_row(self, r):
        nb = self._row.nbytes
        return self._host.tensor[r * nb:(r + 1) * nb]

    def _host_emb(self):
        return self._host.tensor[self.cfg.n_layer * self._row.nbytes:]

    def _fill(self, params):
        """The masters from the JAX tree, a layer row at a time (a
        broadcast stack is never materialized); the moments stay 0."""
        L = self.cfg.n_layer
        emb = [_tensor(_get(params, p)) for p, _ in self._emb]
        stacks = [_tensor(_get(params, ("h", "blk") + p))
                  for p, _ in self._blk]
        want = [s for _, s in self._emb] + [(L,) + s for _, s in self._blk]
        got = [tuple(t.shape) for t in emb + stacks]
        if got != want:
            raise ValueError(f"params have shapes {got}; the model needs "
                             f"{want}")
        with torch.no_grad():
            master = self._emb_lay.sections(self._host_emb())[0]
            for dst, src in zip(self._emb_lay.leaves(master), emb):
                dst.copy_(src)
            for r in range(L):
                master = self._row.sections(self._host_row(r))[0]
                for dst, src in zip(self._row.leaves(master), stacks):
                    dst.copy_(src[r])

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _unit_tree(self, which, dtype):
        """The JAX tree of one state section (0 master, 1 exp_avg_sq, 2
        exp_avg), on the CPU in ``dtype``."""
        self._sync()
        L = self.cfg.n_layer
        rows = [self._row.leaves(self._row.sections(self._host_row(r))[which])
                for r in range(L)]
        tree = {}
        for i, (path, _) in enumerate(self._blk):
            _set(tree, ("h", "blk") + path,
                 torch.stack([rows[r][i].to(dtype) for r in range(L)]))
        emb = self._emb_lay.leaves(
            self._emb_lay.sections(self._host_emb())[which])
        for (path, _), t in zip(self._emb, emb):
            _set(tree, path, t.to(dtype, copy=True))
        return tree

    def params_tree(self, dtype=torch.float32):
        """The masters as the JAX tree, on the CPU."""
        return self._unit_tree(0, dtype)

    def moments_tree(self):
        """(exp_avg, exp_avg_sq) as JAX trees of fp32 CPU tensors."""
        return self._unit_tree(2, torch.float32), \
            self._unit_tree(1, torch.float32)

    @property
    def host_bytes(self):
        return self._host.nbytes

    def transfer_bytes(self):
        """Bytes a step moves each way: the forward's fp32 master rows,
        the backward's whole segment states and the embedding unit in;
        every unit's state out."""
        L, lay = self.cfg.n_layer, self._row
        return {"h2d": L * 4 * lay.n + L * lay.nbytes + self._emb_lay.nbytes,
                "d2h": L * lay.nbytes + self._emb_lay.nbytes}

    # -- the pieces of a step ----------------------------------------------
    def _fetch(self, k, full):
        """Segment ``k``'s rows into device set k % 2 on the copy stream,
        once the set's last reader is done: the fp32 masters alone (the
        forward) or the rows' whole state (the backward, one copy)."""
        s, nb, n4 = k % 2, self._row.nbytes, 4 * self._row.n
        r0 = k * self.rows
        dst = self._sets[s]
        host = self._host.tensor
        with _on(self._h2d):
            if self.cuda:
                self._h2d.wait_event(self._free[s])
            if full:
                dst.copy_(host[r0 * nb:(r0 + self.rows) * nb],
                          non_blocking=True)
            else:
                for j in range(self.rows):
                    a = (r0 + j) * nb
                    dst[j * nb:j * nb + n4].copy_(host[a:a + n4],
                                                  non_blocking=True)
            if self.cuda:
                self._loaded[s].record(self._h2d)

    def _set_rows(self, k):
        nb = self._row.nbytes
        dst = self._sets[k % 2]
        return [dst[j * nb:(j + 1) * nb] for j in range(self.rows)]

    def _cast(self, k):
        """The compute stream waits for segment ``k``'s set and casts its
        masters into the compute rows; returns the rows' flat buffers."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self._loaded[k % 2])
        n = self._row.n
        flats = []
        for j, raw in enumerate(self._set_rows(k)):
            flat = self._pbuf[j * n:(j + 1) * n]
            flat.copy_(self._row.sections(raw)[0])
            flats.append(flat)
        return flats

    def _seg_apply(self, rows, x):
        for leaves in rows:
            x = self.model.block_apply(x, dict(zip(self._names, leaves)))
        return x

    def _embed(self, wte, wpe, ids):
        dt = self.cfg.dtype
        return F.embedding(ids, wte).to(dt) + wpe[:ids.shape[1]].to(dt)[None]

    def _head(self, lnf_scale, lnf_bias, wte, x, labels):
        cfg = self.cfg
        h = F.layer_norm(x.float(), (cfg.n_embd,), lnf_scale.float(),
                         lnf_bias.float(), cfg.layer_norm_epsilon) \
            .to(cfg.dtype)
        w = wte.to(cfg.dtype)
        if cfg.loss_chunk > 0:
            return chunked_lm_loss(h, w, labels, cfg.loss_chunk)
        return lm_loss(torch.matmul(h, w.t()), labels)

    def _update(self, raw, lay, grads, lr, bc):
        """Adam on a unit's state bytes on the card (``grads``: the flat
        gradient of a row, or the embedding unit's leaf gradients)."""
        master, v, m = lay.sections(raw)
        if len(grads) > 1:
            master, v, m = (lay.leaves(t) for t in (master, v, m))
        else:
            master, v, m = [master], [v], [m]
        b1, b2 = self._adam.betas
        self._adam._step_group(master, grads, m, v, lr, None, None, b1, b2,
                               *bc)

    def _store(self, src, dst, after=None):
        """``src`` (device) back to ``dst`` (host) on the second copy
        stream, after the compute stream's work so far."""
        if self.cuda:
            self._d2h.wait_stream(torch.cuda.current_stream(self.device))
        with _on(self._d2h):
            dst.copy_(src, non_blocking=True)
            if after is not None:
                after.record(self._d2h)

    def _mark(self, stream=None):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    # -- the step ------------------------------------------------------------
    def train_batch(self, batch):
        """One streamed step; returns the loss (a float)."""
        cfg, dev = self.cfg, self.device

        def on_card(x):
            return _tensor(x).to(dev)
        ids = on_card(batch["input_ids"])
        labels = on_card(batch.get("labels", batch["input_ids"]))
        self.step_count += 1
        lr = torch.tensor(self.lr, dtype=torch.float32, device=dev)
        cf = torch.tensor(float(self.step_count), device=dev)
        b1, b2 = self._adam.betas
        bc = (1.0 - torch.pow(b1, cf), 1.0 - torch.pow(b2, cf))
        m0 = self._mark()
        if self.cuda:
            # this step reads what the last one copied back
            self._h2d.wait_stream(self._d2h)
        lay = self._emb_lay
        with _on(self._h2d):
            if self.cuda:
                self._h2d.wait_event(self._emb_free)
            self._emb_dev.copy_(self._host_emb(), non_blocking=True)
        if self.cuda:
            torch.cuda.current_stream(dev).wait_stream(self._h2d)
        self._emb_p.copy_(lay.sections(self._emb_dev)[0])
        lnf_b, lnf_s, wpe, wte = lay.leaves(self._emb_p)

        with torch.no_grad():
            x = self._embed(wte, wpe, ids)
            bounds = [x]
            self._fetch(0, full=False)
            for k in range(self.K):
                if k + 1 < self.K:
                    self._fetch(k + 1, full=False)
                flats = self._cast(k)
                if self.cuda:
                    self._free[k % 2].record()
                x = self._seg_apply([self._row.leaves(f) for f in flats], x)
                bounds.append(x)
        m1 = self._mark()

        with torch.enable_grad():
            s_, b_, w_, xk = (t.detach().requires_grad_() for t in
                              (lnf_s, lnf_b, wte, bounds[-1]))
            loss = self._head(s_, b_, w_, xk, labels)
            d_s, d_b, d_wte_head, dx = torch.autograd.grad(
                loss, (s_, b_, w_, xk))
        loss = loss.detach()

        host = self._host.tensor
        nb = self._row.nbytes
        self._fetch(self.K - 1, full=True)
        for k in reversed(range(self.K)):
            if k > 0:
                self._fetch(k - 1, full=True)
            flats = self._cast(k)
            with torch.enable_grad():
                flats = [f.detach().requires_grad_() for f in flats]
                xin = bounds[k].detach().requires_grad_()
                y = self._seg_apply([self._row.leaves(f) for f in flats],
                                    xin)
                grads = torch.autograd.grad(y, flats + [xin], dx)
            dx = grads[-1]
            r0 = k * self.rows
            for j, raw in enumerate(self._set_rows(k)):
                self._update(raw, self._row, [grads[j]], lr, bc)
                a = (r0 + j) * nb
                last = j == self.rows - 1
                self._store(raw, host[a:a + nb],
                            self._free[k % 2] if last and self.cuda
                            else None)
            del grads, y
            bounds[k + 1] = None

        with torch.enable_grad():
            w2, p2 = (t.detach().requires_grad_() for t in (wte, wpe))
            d_wte_emb, d_wpe = torch.autograd.grad(
                self._embed(w2, p2, ids), (w2, p2), dx)
        d_wte = d_wte_head.float() + d_wte_emb.float()
        self._update(self._emb_dev, lay, [d_b, d_s, d_wpe, d_wte], lr, bc)
        self._store(self._emb_dev, self._host_emb(),
                    self._emb_free if self.cuda else None)
        if self.cuda:
            self.step_marks = (m0, m1, self._mark(self._d2h))
        out = float(loss)
        if self._swapper is not None \
                and self.param_bytes <= self._park_threshold:
            self.park_to_nvme()
        return out

    # -- NVMe residency ------------------------------------------------------
    def _leaves_to_write(self, emb_leaf, blk_row):
        """The durable files' leaves in order (the embedding unit's, then
        each block leaf's [L, ...] stack) in ``param_dtype``, one at a
        time, each built in one page-aligned buffer reused for all (so
        O_DIRECT writes it without a bounce): ``emb_leaf(i)`` and
        ``blk_row(i, r)`` give the values."""
        pdt = self.cfg.param_dtype
        L = self.cfg.n_layer
        size = torch.empty((), dtype=pdt).element_size()
        most = max(max(self._emb_lay.sizes), L * max(self._row.sizes))
        buf = aio_lib.aligned_empty(most * size)
        for i, shape in enumerate(self._emb_lay.shapes):
            out = buf[:math.prod(shape) * size].view(pdt).view(shape)
            out.copy_(emb_leaf(i))
            yield out
        for i, shape in enumerate(self._row.shapes):
            out = buf[:L * math.prod(shape) * size].view(pdt).view(
                (L,) + shape)
            for r in range(L):
                out[r].copy_(blk_row(i, r))
            yield out

    def park_to_nvme(self):
        """Rewrite the durable parameter files from the masters."""
        if self._swapper is None:
            raise ValueError("park_to_nvme needs nvme_path")
        self._sync()
        L = self.cfg.n_layer
        emb = self._emb_lay.leaves(self._emb_lay.sections(
            self._host_emb())[0])
        rows = [self._row.leaves(self._row.sections(self._host_row(r))[0])
                for r in range(L)]
        self._swapper.write_all(self._leaves_to_write(
            lambda i: emb[i], lambda i, r: rows[r][i]))

    def restore_from_nvme(self):
        """The masters from the durable files (a cold start; the moments
        stay as they are), streamed through the swapper's read window."""
        if self._swapper is None:
            raise ValueError("restore_from_nvme needs nvme_path")
        self._sync()
        n_emb = len(self._emb)
        want = [s for _, s in self._emb] + [
            (self.cfg.n_layer,) + s for _, s in self._blk]
        got = [tuple(self._swapper.meta[i][0])
               for i in range(len(self._swapper.meta))]
        if got != want:
            raise ValueError(f"the parameter files hold shapes {got}; this "
                             f"model needs {want}")
        emb = self._emb_lay.leaves(self._emb_lay.sections(
            self._host_emb())[0])
        with torch.no_grad():
            for i, view in self._swapper.swap_in_stream():
                if i < n_emb:
                    emb[i].copy_(view)
                    continue
                for r in range(self.cfg.n_layer):
                    master = self._row.sections(self._host_row(r))[0]
                    self._row.leaves(master)[i - n_emb].copy_(view[r])

    def params_on_disk_bytes(self):
        if self._swapper is None:
            return 0
        return sum(os.path.getsize(self._swapper._path(i))
                   for i in range(len(self._swapper.meta)))

    def release(self):
        """Reclaim the durable files (they outlive the process
        otherwise)."""
        if self._swapper is not None:
            self._swapper.release()
            shutil.rmtree(self._swapper.dir, ignore_errors=True)

    def close(self):
        """Free the host state (unregistering it) and the card's buffers."""
        self._sync()
        self._host.close()
        self._sets = self._pbuf = self._emb_dev = self._emb_p = None

    # -- initialize() --------------------------------------------------------
    @classmethod
    def from_config(cls, model, ds_config, model_parameters=None,
                    device=None):
        """The ``initialize()`` dispatch for ``offload_param.
        stream_segments > 0`` (``infinity.py:583``): Adam (AdamW when the
        optimizer type is ``adamw``) with the config's lr, betas, eps and
        weight_decay, exp_avg in the optimizer's ``moment_dtype`` (bf16 by
        default, as JAX's engine). ``model_parameters``: the JAX tree, or
        the port model's state dict; None draws ``gpt2_client_init`` from
        the config's seed. What JAX's engine would silently ignore raises
        here."""
        from deepspeed_tpu_torch.config.config import ROADMAP_INFINITY
        if not isinstance(model, GPT2LMHeadModel):
            raise ValueError(f"offload_param.stream_segments streams GPT-2 "
                             f"(models.gpt2.GPT2LMHeadModel); got "
                             f"{type(model).__name__}")
        ignored = {
            "gradient_clipping": bool(ds_config.gradient_clipping),
            "fp16": ds_config.fp16_enabled,
            "gradient_accumulation_steps > 1":
                ds_config.gradient_accumulation_steps > 1,
            "scheduler": bool(ds_config.scheduler_name)}
        for what, on in ignored.items():
            if on:
                raise NotImplementedError(
                    f"{what} with offload_param.stream_segments: the "
                    f"ZeRO-Infinity engine does not apply it (JAX's engine "
                    f"ignores it silently; {ROADMAP_INFINITY})")
        cfg = model.config
        params = model_parameters
        if params is None:
            params = gpt2_client_init(cfg, seed=ds_config.seed)
        elif "h" not in params:
            params = model.jax_tree(params, scan_layers=True)
        op = dict(ds_config.optimizer_params or {})
        zc = ds_config.zero_config.offload_param
        return cls(cfg, params, device=device, segments=zc.stream_segments,
                   nvme_path=zc.nvme_path, lr=float(op.get("lr", 1e-4)),
                   betas=tuple(op.get("betas", (0.9, 0.999))),
                   eps=float(op.get("eps", 1e-8)),
                   weight_decay=float(op.get("weight_decay", 0.0)),
                   adam_w=(ds_config.optimizer_name or "adamw") == "adamw",
                   moment_dtype=op.get("moment_dtype", "bf16"),
                   aio_config=ds_config.aio_config)
