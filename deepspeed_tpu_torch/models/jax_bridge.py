"""The weight bridge between a port model and a JAX training tree.

A training model of the port keeps flax's parameter names and ``[in,
out]`` kernels, so its named tensors (weights, gradients or Adam moments)
map leaf for leaf onto the JAX package's nested tree, with the layers
unrolled (one subtree a layer) or stacked on a leading axis (the tree
``nn.scan`` makes). The engine writes and reads checkpoints in that
tree through ``jax_tree`` / ``from_jax_tree``.
"""

import numpy as np
import torch


class JaxTreeBridge:
    """``jax_tree`` / ``from_jax_tree`` for an ``nn.Module`` that says
    where each parameter lives: ``jax_paths(scan_layers)`` gives {port
    name: (JAX path, layer of a stacked leaf or None)}, ``scan_tree(tree)``
    whether a JAX tree is layer-stacked, and ``config.scan_layers`` the
    layout ``jax_tree`` writes by default."""

    def jax_tree(self, tensors, scan_layers=None):
        """Port tensors (``{name: tensor}`` in ``named_parameters`` order)
        → the JAX-named nested dict of tensors, layer-stacked when
        ``scan_layers`` (default: the config's)."""
        root, stacks = {}, {}
        for name, (path, layer) in self.jax_paths(scan_layers).items():
            if layer is None:
                _set_path(root, path, tensors[name])
            else:
                stacks.setdefault(path, {})[layer] = tensors[name]
        for path, by_layer in stacks.items():
            _set_path(root, path, torch.stack(
                [by_layer[i] for i in range(len(by_layer))]))
        return root

    def from_jax_tree(self, tree):
        """The JAX training tree (stacked or unrolled, leaves numpy or
        torch) → ``{port name: tensor}`` on the CPU, dtypes kept."""
        out = {}
        for name, (path, layer) in self.jax_paths(
                self.scan_tree(tree)).items():
            node = tree
            for key in path:
                node = node[key]
            t = node if torch.is_tensor(node) else torch.from_numpy(
                np.array(node))
            out[name] = t if layer is None else t[layer]
        return out


def _set_path(root, path, value):
    for key in path[:-1]:
        root = root.setdefault(key, {})
    root[path[-1]] = value
