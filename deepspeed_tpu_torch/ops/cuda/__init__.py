"""Hand-written Hopper kernels, each named after the Pallas function it
replaces. Importing this package builds nothing: the kernels build at
their first launch (builder.py)."""

import functools

import torch

ROADMAP_SECOND_ORDER = ("ROADMAP.md queue 1, item \"Second derivatives of "
                        "the attention kernels\"")


def first_order_only(backward):
    """Mark a kernel Function's backward as differentiable once: it raises
    when autograd runs it while building a graph (``create_graph=True``,
    as a Hessian-vector product does). ``once_differentiable`` would not:
    the backward's outputs carry no graph, so a double backward would run
    on and return the second derivative without the terms through this
    Function."""

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"{type(ctx).__name__.replace('Backward', '')}: a second "
                f"derivative through the attention kernels is not ported; "
                f"their backward is once differentiable "
                f"({ROADMAP_SECOND_ORDER})")
        return backward(ctx, *grads)
    return wrapper
