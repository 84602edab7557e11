"""Hessian max-eigenvalue estimation by power iteration.

Port of ``deepspeed_tpu/runtime/eigenvalue.py`` ``Eigenvalue``: per-layer
power iteration on the loss curvature, which MoQ uses to scale its
quantization periods. JAX's Hessian-vector product is ``jvp`` of
``grad``; here it is a double backward (``torch.autograd.grad`` with
``create_graph=True``, then the gradient of grad · v). For a block of
parameters the vector is zero outside it, so (Hv) restricted to the
block is the derivative of grad_block · v_block by the block, which is
what is computed.

A double backward needs every op of the loss to be twice differentiable.
The attention kernels' Functions are not (``ops.cuda.first_order_only``:
they raise), so the engine runs this on the CPU only, where GPT-2 takes
the plain reference attention (ROADMAP.md queue 1, item "Second
derivatives of the attention kernels").
"""

import math
from typing import Callable, Dict, List, Tuple

import torch


def _normalize(vs):
    """(v / ||v||, ||v|| as a float) over a list of tensors, the norm
    clamped at 1e-12."""
    norm = math.sqrt(sum(float(torch.vdot(v.reshape(-1), v.reshape(-1)))
                         for v in vs))
    norm = max(norm, 1e-12)
    return [v / norm for v in vs], norm


class Eigenvalue:
    def __init__(self,
                 verbose=False,
                 max_iter=100,
                 tol=1e-2,
                 stability=1e-6,
                 gas_boundary_resolution=1,
                 layer_name="",
                 layer_num=0):
        self.verbose = verbose
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability
        self.gas_boundary_resolution = gas_boundary_resolution
        self.layer_name = layer_name
        self.layer_num = layer_num

    @staticmethod
    def hvp(loss_fn: Callable, params, vec):
        """H v over ``params`` (tensors that require grad): the derivative
        of grad(loss_fn()) · vec. A parameter the loss does not reach has
        a zero product."""
        grads = torch.autograd.grad(loss_fn(), params, create_graph=True,
                                    allow_unused=True)
        dot = sum((g * v).sum() for g, v in zip(grads, vec) if g is not None)
        if not torch.is_tensor(dot) or not dot.requires_grad:
            return [torch.zeros_like(p) for p in params]
        hv = torch.autograd.grad(dot, params, allow_unused=True)
        return [torch.zeros_like(p) if h is None else h.detach()
                for h, p in zip(hv, params)]

    def _power_iterate(self, hvp_fn, v):
        """Power iteration from v (normalized first) until the relative
        change of ||Hv|| is under tol or max_iter; returns the last
        ||Hv|| + stability."""
        v, _ = _normalize(v)
        eig = 0.0
        for _ in range(self.max_iter):
            hv = [torch.nan_to_num(h, nan=0.0, posinf=0.0, neginf=0.0)
                  for h in hvp_fn(v)]
            v, new_eig = _normalize(hv)
            if eig > 0 and abs(new_eig - eig) / max(eig, 1e-12) < self.tol:
                eig = new_eig
                break
            eig = new_eig
        return eig + self.stability

    def compute_eigenvalue(self, loss_fn: Callable, params, v=None,
                           generator=None) -> float:
        """Dominant Hessian eigenvalue of ``loss_fn()`` over ``params``,
        from ``v`` (default: N(0, 1) draws from ``generator``)."""
        params = list(params)
        if v is None:
            v = [torch.randn(p.shape, generator=generator, device=p.device)
                 for p in params]
        return self._power_iterate(
            lambda vv: self.hvp(loss_fn, params, vv), v)

    @staticmethod
    def find_layer_blocks(tree) -> List[Tuple[str, list]]:
        """Per-transformer-layer subtrees of a nested dict, numerically
        ordered: the dict with the most children whose names end in a
        layer index (GPT-2's ``h_3``, BERT's ``..._3``); [(name, key
        path)] sorted by index. JAX's walk, key for key."""
        def layer_idx(name):
            tail = name.rsplit("_", 1)[-1] if "_" in name else name
            return int(tail) if tail.isdigit() else None

        best: Tuple[list, Dict[int, str]] = ([], {})
        stack = [(tree, [])]
        while stack:
            node, path = stack.pop()
            if not isinstance(node, dict):
                continue
            idxmap = {}
            for k in node.keys():
                i = layer_idx(str(k))
                if i is not None:
                    idxmap[i] = k
            if len(idxmap) > len(best[1]):
                best = (path, idxmap)
            for k, sub in node.items():
                stack.append((sub, path + [k]))
        path, idxmap = best
        return [(idxmap[i], path + [idxmap[i]]) for i in sorted(idxmap)]

    def compute_layer_eigenvalues(self, loss_fn: Callable, named,
                                  jax_paths=None, generator=None,
                                  start=None) -> List[float]:
        """Per-transformer-layer eigenvalues, index-aligned with MoQ's
        per-layer schedules. ``named``: {name: parameter}; ``jax_paths``:
        the model's {name: (JAX path, layer or None)} (the blocks are
        found in its JAX tree, as JAX finds them; None: the dotted names).
        ``start``: per block, {name: start vector} (default: N(0, 1)
        draws from ``generator``). With no layer blocks, one eigenvalue
        over every parameter."""
        tree, members = {}, {}
        for name in named:
            path = jax_paths[name][0] if jax_paths is not None \
                else tuple(name.split("."))
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node.setdefault(path[-1], [])
            members[name] = path
        blocks = self.find_layer_blocks(tree)
        if not blocks:
            return [self.compute_eigenvalue(loss_fn, named.values(),
                                            generator=generator)]
        results = []
        for i, (_, key_path) in enumerate(blocks):
            names = [n for n, p in members.items()
                     if list(p[:len(key_path)]) == list(key_path)]
            v = None if start is None else [start[i][n] for n in names]
            results.append(self.compute_eigenvalue(
                loss_fn, [named[n] for n in names], v, generator))
        return results
