"""Checkpoint save/load in the JAX package's single-process format.

Port of ``deepspeed_tpu/runtime/checkpointing.py`` for one rank: tag
directories, the ``latest`` pointer file and the staged two-rename
``commit_dir_swap`` (:255). A tag directory holds

  - ``model_states_shard_0.npz``  — the param tree's pieces,
  - ``optim_states_shard_0.npz``  — optimizer state, scaler, counters,
  - ``shard_index_0.json``        — for every piece: its tree path, npz
    key, global shape, dtype string and index window,
  - ``meta.json``                 — counters, scheduler and client state.

Pieces are raw bytes (npz cannot carry bfloat16) with the dtype in the
index (:113-139). Reading takes the union of every ``shard_index_*.json``
and assembles each leaf's window with numpy on bytes, then views them
through ``torch.uint8`` as the stored dtype, so no ``ml_dtypes`` is needed.
Tree paths are the JAX names (the model's bridge maps them), so a
checkpoint the JAX engine wrote resumes here and this one resumes there.
"""

import json
import os
import shutil

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


def _save_trees(ckpt_dir, trees):
    """trees: {file stem: nested dict of tensors}. One piece per leaf, the
    whole window, as rank 0 of a one-process JAX save writes it."""
    index = {}
    for stem, tree in trees.items():
        pieces = {}
        for path, leaf in _walk(tree):
            key = f"{path}//0"
            pieces[key] = _to_bytes(leaf)
            index[f"{stem}:{path}"] = {
                "file": f"{stem}_shard_0.npz",
                "shape": list(leaf.shape),
                "dtype": _DTYPE_NAMES[leaf.dtype],
                "pieces": [{"key": key, "start": [0] * leaf.dim(),
                            "stop": list(leaf.shape)}]}
        np.savez(os.path.join(ckpt_dir, f"{stem}_shard_0.npz"), **pieces)
    with open(os.path.join(ckpt_dir, "shard_index_0.json"), "w") as f:
        json.dump(index, f)


class ShardedCheckpoint:
    """Reader over the union of all ranks' shard index files."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = ckpt_dir
        self.leaves = {}   # "stem:path" -> {shape, dtype, pieces}
        self._files = {}
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
        self._files = {}

    def _piece(self, file, key):
        if file not in self._files:
            self._files[file] = np.load(os.path.join(self.ckpt_dir, file),
                                        allow_pickle=False)
        return self._files[file][key]

    def read(self, full):
        """One whole leaf as a CPU tensor of its stored dtype, assembled
        from whichever pieces cover it (bytes, trailing axis of itemsize)."""
        info = self.leaves[full]
        shape, dtype = info["shape"], _TORCH_DTYPES[info["dtype"]]
        item = torch.empty((), dtype=dtype).element_size()
        out = np.empty(list(shape) + [item], np.uint8)
        filled = 0
        for p in info["pieces"]:
            dims = [b - a for a, b in zip(p["start"], p["stop"])]
            src = np.asarray(self._piece(p["file"], p["key"]), np.uint8)
            out[tuple(slice(a, b) for a, b in zip(p["start"], p["stop"]))] = \
                src.reshape(dims + [item])
            filled += int(np.prod(dims))
        if filled != int(np.prod(shape)):
            raise IOError(
                f"checkpoint leaf {full} assembled {filled} of "
                f"{int(np.prod(shape))} elements: shard files in "
                f"{self.ckpt_dir} are missing or duplicated")
        return torch.from_numpy(out).view(dtype).reshape(shape)

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
                    zero_stage=0):
    """``state``: {"params", "opt_state", "scaler", "global_step",
    "skipped_steps"} with JAX-named nested dicts of tensors."""
    final_dir = os.path.join(save_dir, str(tag))
    ckpt_dir = final_dir + ".saving"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir, exist_ok=True)
    _save_trees(ckpt_dir, {
        "model_states": {"params": state["params"]},
        "optim_states": {k: state[k] for k in
                         ("opt_state", "scaler", "global_step",
                          "skipped_steps")}})
    meta = dict(extra)
    meta["zero_stage"] = zero_stage
    meta["world_size"] = 1
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump(meta, f, default=str)
    commit_dir_swap(ckpt_dir, final_dir)
    if save_latest:
        with open(os.path.join(save_dir, LATEST_FILE), "w") as f:
            f.write(str(tag))


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


def load_checkpoint(load_dir, tag=None, load_optimizer=True):
    """({params, opt_state, scaler, global_step, skipped_steps} as nested
    dicts of CPU tensors, meta), or None when there is nothing to load.
    ``load_optimizer=False`` skips the optimizer state's bytes."""
    if tag is None:
        tag = read_latest_tag(load_dir)
        if tag is None:
            return None
    ckpt_dir = resolve_ckpt_dir(load_dir, tag)
    try:
        reader = ShardedCheckpoint(ckpt_dir)
    except (FileNotFoundError, NotADirectoryError):
        return None
    try:
        state = reader.tree("model_states")
        state.update(reader.tree(
            "optim_states", skip=() if load_optimizer else ("opt_state/",)))
    finally:
        reader.close()
    state.setdefault("opt_state", {})
    return state, _load_meta(ckpt_dir)
