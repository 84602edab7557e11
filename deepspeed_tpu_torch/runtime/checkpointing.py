"""Checkpoint save/load in the JAX package's per-process format.

Port of ``deepspeed_tpu/runtime/checkpointing.py``: tag directories, the
``latest`` pointer file and the staged two-rename ``commit_dir_swap``
(:255). A tag directory holds, per rank r,

  - ``model_states_shard_{r}.npz``  — the rank's pieces of the param tree,
  - ``optim_states_shard_{r}.npz``  — of the optimizer state, scaler and
    counters,
  - ``shard_index_{r}.json``        — for every piece: its tree path, npz
    key, global shape, dtype string and index window,

and (rank 0) ``meta.json`` (counters, scheduler and client state, the
world size). A leaf is a tensor (written whole, by rank 0) or ``Pieces``:
the windows of a global leaf that the rank owns (its shards; a
replicated leaf's whole window at rank 0 alone, JAX's replica 0). At
world size n the ranks write into the staging directory that rank 0
made, and rank 0 commits it after a barrier, once every rank's files are
there (:280).

Pieces are raw bytes (npz cannot carry bfloat16) with the dtype in the
index (:113-139). Reading takes the union of every ``shard_index_*.json``
and assembles any window of a leaf from the pieces that cover it, with
numpy on bytes viewed through ``torch.uint8`` as the stored dtype (no
``ml_dtypes``), so a save at n ranks restores at another n or on one
rank. Tree paths are the JAX names (the model's bridge maps them), so a
checkpoint the JAX engine wrote resumes here and this one resumes there.
"""

import dataclasses

import json
import os
import shutil
from typing import List, Tuple

import numpy as np
import torch

LATEST_FILE = "latest"

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int32": torch.int32,
                 "int64": torch.int64, "bool": torch.bool,
                 "uint8": torch.uint8, "int8": torch.int8,
                 "float64": torch.float64}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _unflatten(flat):
    root = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _to_bytes(t):
    """A tensor's raw bytes as a flat numpy uint8 array."""
    t = t.detach().to("cpu").contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().copy() if t.numel() \
        else np.zeros(0, np.uint8)


@dataclasses.dataclass
class Pieces:
    """The windows of one global leaf that a rank writes: ``shape`` and
    ``dtype`` of the leaf, ``windows`` a list of (start index, tensor)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    windows: List[tuple] = dataclasses.field(default_factory=list)


def _save_trees(ckpt_dir, trees, rank=0):
    """trees: {file stem: nested dict of tensors or ``Pieces``}: a tensor
    is one piece, the whole window; ``Pieces`` one piece a window."""
    index = {}
    for stem, tree in trees.items():
        pieces = {}
        for path, leaf in _walk(tree):
            if not isinstance(leaf, Pieces):
                leaf = Pieces(tuple(leaf.shape), leaf.dtype,
                              [((0,) * leaf.dim(), leaf)])
            entries = []
            for j, (start, t) in enumerate(leaf.windows):
                key = f"{path}//{j}"
                pieces[key] = _to_bytes(t)
                entries.append({"key": key, "start": list(start),
                                "stop": [a + b for a, b in
                                         zip(start, t.shape)]})
            index[f"{stem}:{path}"] = {
                "file": f"{stem}_shard_{rank}.npz",
                "shape": list(leaf.shape),
                "dtype": _DTYPE_NAMES[leaf.dtype], "pieces": entries}
        np.savez(os.path.join(ckpt_dir, f"{stem}_shard_{rank}.npz"),
                 **pieces)
    with open(os.path.join(ckpt_dir, f"shard_index_{rank}.json"), "w") as f:
        json.dump(index, f)


class ShardedCheckpoint:
    """Reader over the union of all ranks' shard index files."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = ckpt_dir
        self.leaves = {}   # "stem:path" -> {shape, dtype, pieces}
        self._files, self._cache, self._cached_leaf = {}, {}, None
        names = sorted(f for f in os.listdir(ckpt_dir)
                       if f.startswith("shard_index_") and f.endswith(".json"))
        if not names:
            raise FileNotFoundError(f"no shard_index_*.json in {ckpt_dir}")
        for fname in names:
            with open(os.path.join(ckpt_dir, fname)) as f:
                for full, info in json.load(f).items():
                    entry = self.leaves.setdefault(full, {
                        "shape": tuple(info["shape"]),
                        "dtype": info["dtype"], "pieces": []})
                    for p in info["pieces"]:
                        entry["pieces"].append({"file": info["file"], **p})

    def close(self):
        for f in self._files.values():
            f.close()
        self._files, self._cache, self._cached_leaf = {}, {}, None

    def _piece(self, file, key):
        """A piece's bytes; the pieces of the last leaf read stay cached,
        so reading a stacked leaf's layers one by one loads each piece
        once."""
        if (file, key) not in self._cache:
            if file not in self._files:
                self._files[file] = np.load(
                    os.path.join(self.ckpt_dir, file), allow_pickle=False)
            self._cache[(file, key)] = self._files[file][key]
        return self._cache[(file, key)]

    def paths(self, stem):
        """The nested dict of the tree's leaf paths (leaves True)."""
        pre = f"{stem}:"
        return _unflatten({full[len(pre):]: True for full in self.leaves
                           if full.startswith(pre)})

    def read(self, full):
        """One whole leaf as a CPU tensor of its stored dtype."""
        shape = self.leaves[full]["shape"]
        return self.window(full, (0,) * len(shape), shape)

    def window(self, full, start, stop):
        """The window [start, stop) of a leaf as a CPU tensor of its stored
        dtype, assembled from whichever pieces overlap it (bytes, a
        trailing axis of itemsize)."""
        if full != self._cached_leaf:
            self._cache, self._cached_leaf = {}, full
        info = self.leaves[full]
        dtype = _TORCH_DTYPES[info["dtype"]]
        item = torch.empty((), dtype=dtype).element_size()
        dims = [b - a for a, b in zip(start, stop)]
        out = np.empty(dims + [item], np.uint8)
        filled = 0
        for p in info["pieces"]:
            lo = [max(a, pa) for a, pa in zip(start, p["start"])]
            hi = [min(b, pb) for b, pb in zip(stop, p["stop"])]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            pdims = [b - a for a, b in zip(p["start"], p["stop"])]
            src = np.asarray(self._piece(p["file"], p["key"]),
                             np.uint8).reshape(pdims + [item])
            out[tuple(slice(a - s, b - s) for a, b, s in
                      zip(lo, hi, start))] = \
                src[tuple(slice(a - s, b - s) for a, b, s in
                          zip(lo, hi, p["start"]))]
            filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
        if filled != int(np.prod(dims)):
            raise IOError(
                f"checkpoint leaf {full} assembled {filled} of "
                f"{int(np.prod(dims))} elements: shard files in "
                f"{self.ckpt_dir} are missing or duplicated")
        return torch.from_numpy(out).view(dtype).reshape(dims)

    def tree(self, stem, skip=()):
        pre = f"{stem}:"
        return _unflatten({full[len(pre):]: self.read(full)
                           for full in self.leaves if full.startswith(pre)
                           and not full[len(pre):].startswith(skip)})


def commit_dir_swap(stage_dir, final_dir):
    """The two-rename publish: move the existing final dir aside, swap the
    finished staging dir in, drop the old one. A crash in between leaves
    the old tag or ``{tag}.old``, never a half-written final dir
    (``resolve_ckpt_dir`` finds the survivor)."""
    old_dir = final_dir + ".old"
    shutil.rmtree(old_dir, ignore_errors=True)
    if os.path.isdir(final_dir):
        os.rename(final_dir, old_dir)
    os.rename(stage_dir, final_dir)
    shutil.rmtree(old_dir, ignore_errors=True)


def save_checkpoint(save_dir, tag, state, extra, save_latest=True,
                    zero_stage=0, mesh=None):
    """``state``: {"params", "opt_state", "scaler", "global_step",
    "skipped_steps"} with JAX-named nested dicts of tensors or ``Pieces``
    (this rank's; an entry a rank does not write is left out). ``mesh``:
    the world, when every rank of it calls this (collective)."""
    rank = 0 if mesh is None else mesh.rank
    final_dir = os.path.join(save_dir, str(tag))
    ckpt_dir = final_dir + ".saving"
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        os.makedirs(ckpt_dir, exist_ok=True)
    if mesh is not None:
        mesh.barrier()
    _save_trees(ckpt_dir, {
        "model_states": {"params": state["params"]},
        "optim_states": {k: state[k] for k in
                         ("opt_state", "scaler", "global_step",
                          "skipped_steps") if k in state}}, rank)
    # the commit waits for every rank's files, and no rank goes on (to a
    # load of this tag, say) before the commit
    if mesh is not None:
        mesh.barrier()
    if rank == 0:
        meta = dict(extra)
        meta["zero_stage"] = zero_stage
        meta["world_size"] = 1 if mesh is None else mesh.size
        with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
            json.dump(meta, f, default=str)
        commit_dir_swap(ckpt_dir, final_dir)
        if save_latest:
            with open(os.path.join(save_dir, LATEST_FILE), "w") as f:
                f.write(str(tag))
    if mesh is not None:
        mesh.barrier()


def read_latest_tag(load_dir):
    latest_path = os.path.join(load_dir, LATEST_FILE)
    if os.path.isfile(latest_path):
        with open(latest_path) as f:
            return f.read().strip()
    return None


def resolve_ckpt_dir(load_dir, tag):
    """Directory for ``tag``, falling back to ``{tag}.old`` (a crash
    between the two renames leaves the only valid save there)."""
    final_dir = os.path.join(load_dir, str(tag))
    if not os.path.isdir(final_dir) and os.path.isdir(final_dir + ".old"):
        return final_dir + ".old"
    return final_dir


def _load_meta(ckpt_dir):
    meta = {}
    path = os.path.join(ckpt_dir, "meta.json")
    if os.path.isfile(path):
        with open(path) as f:
            meta = json.load(f)
    for key in ("global_steps", "micro_steps", "global_samples",
                "skipped_steps"):
        if key in meta:
            try:
                meta[key] = int(meta[key])
            except (TypeError, ValueError):
                pass
    return meta


def open_checkpoint(load_dir, tag=None):
    """(a ``ShardedCheckpoint`` reader over the tag's directory, its meta),
    or None when there is nothing to load; the caller closes the
    reader."""
    if tag is None:
        tag = read_latest_tag(load_dir)
        if tag is None:
            return None
    ckpt_dir = resolve_ckpt_dir(load_dir, tag)
    try:
        return ShardedCheckpoint(ckpt_dir), _load_meta(ckpt_dir)
    except (FileNotFoundError, NotADirectoryError):
        return None


def load_checkpoint(load_dir, tag=None, load_optimizer=True):
    """({params, opt_state, scaler, global_step, skipped_steps} as nested
    dicts of CPU tensors, meta), or None when there is nothing to load.
    ``load_optimizer=False`` skips the optimizer state's bytes."""
    opened = open_checkpoint(load_dir, tag)
    if opened is None:
        return None
    reader, meta = opened
    try:
        state = reader.tree("model_states")
        state.update(reader.tree(
            "optim_states", skip=() if load_optimizer else ("opt_state/",)))
    finally:
        reader.close()
    state.setdefault("opt_state", {})
    return state, meta
