"""Grouped fake quantization: the CUDA kernel (csrc/quantize.cu) and its
plain PyTorch version.

Replaces ``deepspeed_tpu/ops/pallas/quantize.py:109`` ``quantize``
(``_quant_kernel`` :76): x of any shape, seen as [groups, n], quantized
to ``bits`` bits a group and dequantized back to x's dtype. The
arithmetic is the Pallas kernel's as XLA runs it: the division of the
group's amax (or range) by the constant qmax becomes a product with
fp32(1 / qmax), then x is divided by that scale (an IEEE division), so
``quantize_plain`` equals JAX's ``quantize`` bit for bit with nearest
rounding; ``quantize_jnp`` (:47) divides by qmax itself and can differ
from both in the scale's last bit. Stochastic rounding takes u from a
``torch.Generator`` (the kernel: Philox keyed by a seed a leaf drawn
from it); it matches JAX's draws only in distribution.

``quantize_leaves`` quantizes a whole table of leaves (a MoQ boundary)
in one launch: each leaf a list of pieces whose concatenation is its
[groups, n], with its own bits and groups, all sharing sym, rounding and
an optional blend with the unquantized values. ``quantize`` is its
one-leaf case. The launch walks ``work_list``: R (reduce) and A (apply)
tiles cut at piece and group edges, in windows of whole groups that stay
in L2 between a tile's R and A visits (see csrc/quantize.cu).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

import collections
import functools
import math

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda import builder

# the work list: tiles of at most TILE_BYTES; windows of whole groups of
# at most WINDOW_BYTES (a larger group is a window of its own, whose A
# tiles run last-read first); window w - 1's A tiles interleaved with
# window w's R tiles, LAG_TILES behind
TILE_BYTES = 32768
WINDOW_BYTES = 12 << 20
LAG_TILES = 32
# persistent blocks an SM (the kernel's registers allow 4)
BLOCKS_PER_SM = 4
# tickets (tiles) a launch: a larger table is split between leaves into
# launches in table order, each counted
MAX_TICKETS = 2 ** 31 - 1

# a work-list entry as csrc/quantize.cu reads it (struct Tile)
TILE_DT = np.dtype([("src", "<u8"), ("dst", "<u8"), ("li0", "<i8"),
                    ("ck", "<u4"), ("group", "<u4"), ("need", "<u4"),
                    ("meta", "<u4"), ("pad", "<u4", 2)])


def qrange(bits, sym):
    """(lowest code, highest code) as floats."""
    if sym:
        qmax = 2.0 ** (bits - 1) - 1
        return -qmax - 1, qmax
    return 0.0, 2.0 ** bits - 1


def rcp(bits, sym):
    """fp32(1 / qmax) (symmetric) or fp32(1 / (2^bits - 1)): the product
    XLA makes of the Pallas kernel's division by the constant."""
    d = qrange(bits, sym)[1]
    return float(np.float32(1.0 / d)) if d else math.inf


def _check_groups(numel, groups):
    if numel % groups != 0:
        raise ValueError(f"numel {numel} not divisible by groups {groups}")


def _groups_view(x, groups):
    _check_groups(x.numel(), groups)
    return x.reshape(groups, x.numel() // groups)


def qparams_plain(flat, bits, sym):
    """(scale [G, 1], zero [G, 1] or None) in fp32 of flat [G, n] fp32
    (``_quant_kernel``'s reductions; a NaN in a group propagates)."""
    r = torch.tensor(rcp(bits, sym), dtype=torch.float32, device=flat.device)
    if sym:
        scale, zero = flat.abs().amax(-1, keepdim=True) * r, None
    else:
        zero = flat.amin(-1, keepdim=True)
        scale = (flat.amax(-1, keepdim=True) - zero) * r
    return torch.where(scale == 0, 1.0, scale), zero


def apply_plain(flat, scale, zero, bits, u=None):
    """Round flat [G, n] fp32 at (scale, zero) to codes and back: nearest
    (half to even), or floor(t + u) with u [G, n] in [0, 1)."""
    lo, hi = qrange(bits, zero is None)
    t = flat / scale if zero is None else (flat - zero) / scale
    q = torch.round(t) if u is None else torch.floor(t + u)
    out = torch.clamp(q, lo, hi) * scale
    return out if zero is None else out + zero


def quantize_plain(x, bits=8, groups=1, sym=True, stochastic=False,
                   generator=None):
    """Grouped fake quantization in torch ops, in x's dtype; see the
    module docstring. Stochastic rounding draws u with ``torch.rand``
    from ``generator`` (None: the default one)."""
    flat = _groups_view(x, groups).float()
    scale, zero = qparams_plain(flat, bits, sym)
    u = torch.rand(flat.shape, generator=generator, device=flat.device) \
        if stochastic else None
    return apply_plain(flat, scale, zero, bits, u).reshape(x.shape).to(
        x.dtype)


def quantize_leaves_plain(leaves, sym=True, stochastic=False, ratio=None,
                          generator=None, outs=None):
    """``quantize_leaves`` in torch ops, leaf by leaf in table order: a
    leaf's pieces concatenated, ``quantize_plain``, the blend as
    ``q.mul_(1 - r)``, ``x * r + q``, the result split back into the
    outputs."""
    outs = _outs(leaves, outs)
    for (pieces, bits, groups), dst in zip(leaves, outs):
        arr = pieces[0] if len(pieces) == 1 else torch.cat(
            [p.reshape(-1) for p in pieces])
        q = quantize_plain(arr, bits, groups, sym, stochastic, generator)
        if ratio is not None:
            q.mul_(1.0 - ratio)
            q = arr.mul(ratio).add_(q)
        if len(pieces) == 1:
            dst[0].copy_(q)
        else:
            for d, part in zip(dst, q.split([p.numel() for p in pieces])):
                d.copy_(part.view(d.shape))
    return outs


def _outs(leaves, outs):
    """The outputs of each leaf's pieces: the pieces themselves (in
    place) or ``outs``, checked against them."""
    if outs is None:
        return [list(pieces) for pieces, _, _ in leaves]
    if len(outs) != len(leaves):
        raise ValueError("quantize_leaves: outs must give a list of "
                         "outputs for every leaf")
    for (pieces, _, _), dst in zip(leaves, outs):
        if len(dst) != len(pieces) or any(
                d.shape != p.shape or d.dtype != p.dtype
                or d.device != p.device for d, p in zip(dst, pieces)):
            raise ValueError("quantize_leaves: each output must have its "
                             "piece's shape, dtype and device")
    return [list(d) for d in outs]


# -- the work list ------------------------------------------------------------

WorkList = collections.namedtuple("WorkList", [
    "kind",     # [T] 0: an R tile, 1: an A tile, in ticket order
    "piece",    # [T] the tile's piece (over the whole table)
    "start",    # [T] its first element in the piece
    "count",    # [T] its elements
    "group",    # [T] its group (over the whole table)
    "need",     # [G] R tiles a group
    "window",   # [G] each group's window
    "group_bytes",   # [G]
])


def _segments(numels, groups):
    """One leaf's runs within one piece and one group: (piece, start in
    the piece, length, group), each a numpy array, in order."""
    numels = np.asarray(numels, np.int64)
    total = int(numels.sum())
    n = total // groups
    pstart = np.concatenate([[0], np.cumsum(numels)[:-1]])
    live = np.nonzero(numels > 0)[0]
    edges = np.union1d(pstart[live], np.arange(groups, dtype=np.int64) * n)
    ends = np.append(edges[1:], total)
    piece = live[np.searchsorted(pstart[live], edges, side="right") - 1]
    return piece, edges - pstart[piece], ends - edges, edges // n


def _leaf_tiles(numels, esize, groups, tile_bytes):
    """Tiles (R or A) one leaf cuts into."""
    if sum(numels) == 0:
        return 0
    _, _, length, _ = _segments(numels, groups)
    te = max(1, tile_bytes // esize)
    return int(((length + te - 1) // te).sum())


def work_list(leaves, tile_bytes=None, window_bytes=None, lag=None):
    """The ticket order of one launch over ``leaves``: [(piece numels,
    element bytes, groups)]. Each piece-and-group run is cut into tiles
    of at most ``tile_bytes``; groups are gathered in table order into
    windows of at most ``window_bytes`` (a larger group alone); the
    tickets run window 0's R tiles, then window w's R tiles interleaved
    with window w - 1's A tiles (each A tile ``lag`` R tiles behind its
    share), then the last window's A tiles. The A tiles of a window larger
    than ``window_bytes`` run in reverse, the last read (the most likely
    to be still in L2) first."""
    tile_bytes = tile_bytes or TILE_BYTES
    window_bytes = window_bytes or WINDOW_BYTES
    lag = LAG_TILES if lag is None else lag
    parts, p0, g0, gbytes = [], 0, 0, []
    for numels, esize, groups in leaves:
        total = int(sum(numels))
        _check_groups(total, groups)
        if total == 0:
            p0 += len(numels)
            continue
        piece, start, length, group = _segments(numels, groups)
        te = max(1, tile_bytes // esize)
        parts.append((piece + p0, start, length, group + g0,
                      np.full(len(piece), te, np.int64)))
        gbytes.append(np.full(groups, total // groups * esize, np.int64))
        p0 += len(numels)
        g0 += groups
    if not parts:
        e = np.zeros(0, np.int64)
        return WorkList(e, e, e, e, e, e, e, e)
    piece, start, length, group, te = (np.concatenate(c) for c in zip(*parts))
    gbytes = np.concatenate(gbytes)
    # tiles of each run
    ntile = (length + te - 1) // te
    seg = np.repeat(np.arange(len(ntile)), ntile)
    k = np.arange(len(seg)) - np.repeat(np.cumsum(ntile) - ntile, ntile)
    t_start = start[seg] + k * te[seg]
    t_count = np.minimum(te[seg], length[seg] - k * te[seg])
    t_group, t_piece = group[seg], piece[seg]
    need = np.bincount(t_group, minlength=g0)
    # windows of whole groups
    window = np.zeros(g0, np.int64)
    w, acc, big = 0, 0, [False]
    for g, b in enumerate(gbytes.tolist()):
        if acc and acc + b > window_bytes:
            w, acc = w + 1, 0
            big.append(False)
        acc += b
        window[g] = w
        big[w] = acc > window_bytes
    # the ticket order: sort R and A tiles by (step, key, kind)
    t_win = window[t_group]
    n_win = np.bincount(t_win, minlength=w + 2)     # tiles a window
    first = np.cumsum(n_win) - n_win
    idx = np.arange(len(seg)) - first[t_win]         # rank in its window
    idx_a = np.where(np.asarray(big)[t_win], n_win[t_win] - 1 - idx, idx)
    # step s runs window s's R tiles (n_r of them) and window s - 1's A
    # tiles (n_a): R tile i at key i·n_a, A tile j at j·n_r + lag·n_a, so A
    # tile j follows about lag + j·n_r/n_a R tiles
    n_a_of_r = n_win[t_win - 1] * (t_win > 0)
    n_r_of_a, n_a_of_a = n_win[t_win + 1], n_win[t_win]
    step = np.concatenate([t_win, t_win + 1])
    key = np.concatenate([idx * n_a_of_r,
                          idx_a * n_r_of_a + lag * n_a_of_a])
    kind = np.repeat([0, 1], len(seg))
    order = np.lexsort((kind, key, step))

    def both(a):          # a tile's R and A entries, in ticket order
        return np.concatenate([a, a])[order]
    return WorkList(kind[order], both(t_piece), both(t_start),
                    both(t_count), both(t_group), need, window, gbytes)


def launch_split(tiles_per_leaf, max_tickets=None):
    """Leaf ranges [(lo, hi)] of the launches a table takes: consecutive
    leaves while their tickets (2 a tile) stay within ``max_tickets``."""
    max_tickets = max_tickets or MAX_TICKETS
    out, lo, acc = [], 0, 0
    for i, t in enumerate(tiles_per_leaf):
        if 2 * t > max_tickets:
            raise NotImplementedError(
                f"quantize_leaves: leaf {i} alone takes {2 * t} tickets, "
                f"over {max_tickets} a launch")
        if acc + 2 * t > max_tickets:
            out.append((lo, i))
            lo, acc = i, 0
        acc += 2 * t
    out.append((lo, len(tiles_per_leaf)))
    return out


# -- on the card --------------------------------------------------------------

Launch = collections.namedtuple("Launch", [
    "tiles", "scratch", "n_groups", "leaf_lo", "leaf_hi", "params"])

_PLANS = collections.OrderedDict()
_PLANS_SIZE = 64


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _pack(leaves, outs, device):
    """One launch's work list as its device table of ``TILE_DT`` entries,
    and its zeroed scratch (the kernel leaves it zeroed)."""
    wl = work_list([([p.numel() for p in ps], ps[0].element_size(), groups)
                    for ps, _, groups in leaves])
    src = [p for ps, _, _ in leaves for p in ps]
    dst = [d for ds in outs for d in ds]
    esize = np.array([p.element_size() for p in src], np.int64)
    sptr = np.array([p.data_ptr() for p in src], np.int64)
    dptr = np.array([d.data_ptr() for d in dst], np.int64)
    sizes = [len(ps) for ps, _, _ in leaves]
    leaf = np.repeat(np.arange(len(leaves)), sizes)
    leaf_off = np.concatenate([np.cumsum([0] + [p.numel() for p in ps[:-1]])
                               for ps, _, _ in leaves])
    is_bf16 = np.array([ps[0].dtype == torch.bfloat16
                        for ps, _, _ in leaves], np.uint32)
    vec_ok = ((sptr - dptr) % 16 == 0).astype(np.uint32)
    p, L = wl.piece, leaf[wl.piece]
    tiles = np.zeros(len(p), TILE_DT)
    tiles["src"] = sptr[p] + wl.start * esize[p]
    tiles["dst"] = dptr[p] + wl.start * esize[p]
    tiles["li0"] = leaf_off[p] + wl.start
    tiles["ck"] = wl.count.astype(np.uint32) | (wl.kind.astype(np.uint32)
                                                << 31)
    tiles["group"] = wl.group
    tiles["need"] = wl.need[wl.group]
    tiles["meta"] = is_bf16[L] | (vec_ok[p] << 1) | (L.astype(np.uint32)
                                                     << 8)
    scratch = torch.zeros((len(wl.need) + 1) * 4, dtype=torch.int32,
                          device=device)
    return torch.from_numpy(tiles.view(np.uint8)).to(device), scratch, \
        len(wl.need)


def _plan(leaves, outs, device):
    """The launches of a table, made once and cached per (the pieces' and
    outputs' addresses, sizes, dtypes and contiguity, groups, the
    work-list constants): the work list lives on the card, so a CUDA
    graph can replay a launch; a table first seen while capturing raises.
    The checks run when a table is first seen."""
    key = (device.index, TILE_BYTES, WINDOW_BYTES, LAG_TILES, MAX_TICKETS,
           outs is None, tuple(
               (groups, tuple((p.data_ptr(), p.numel(), p.dtype,
                               p.is_contiguous()) for p in pieces))
               for pieces, _, groups in leaves))
    if outs is not None:
        key += tuple((d.data_ptr(), d.numel(), d.dtype, d.is_contiguous())
                     for ds in outs for d in ds),
    hit = _PLANS.get(key)
    if hit is not None:
        _PLANS.move_to_end(key)
        return hit
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("quantize_leaves: a table first seen while a CUDA "
                           "graph is captured; call it once before capture")
    outs = _outs(leaves, outs)
    _check_cuda(leaves, outs, "quantize_leaves")
    tiles = [_leaf_tiles([p.numel() for p in pieces], pieces[0].element_size(),
                         groups, TILE_BYTES)
             for pieces, _, groups in leaves]
    plan = []
    for lo, hi in launch_split(tiles):
        if sum(tiles[lo:hi]):
            plan.append(Launch(*_pack(leaves[lo:hi], outs[lo:hi], device),
                               lo, hi, {}))
    _PLANS[key] = plan
    while len(_PLANS) > _PLANS_SIZE:
        _PLANS.popitem(last=False)
    return plan


def _leaf_params(launch, leaves, sym):
    """A launch's (bits, fp32 rcp's bits) a leaf on the card, made once
    for each bit widths and sym it is called with (a new bit width costs a
    small copy, not a new work list)."""
    bits = tuple(b for _, b, _ in leaves[launch.leaf_lo:launch.leaf_hi])
    key = (bool(sym), bits)
    hit = launch.params.get(key)
    if hit is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quantize_leaves: bit widths first seen while "
                               "a CUDA graph is captured; call it once "
                               "before capture")
        lp = np.zeros((len(bits), 2), np.uint32)
        lp[:, 0] = bits
        lp[:, 1] = np.array([rcp(b, sym) for b in bits],
                            np.float32).view(np.uint32)
        hit = launch.params[key] = torch.from_numpy(lp.view(np.int32)).to(
            launch.tiles.device)
    return hit


def _check_cuda(leaves, outs, fn):
    device = leaves[0][0][0].device
    seen = set()
    for (pieces, _, groups), dst in zip(leaves, outs):
        if not pieces:
            raise ValueError(f"{fn}: a leaf needs at least one piece")
        dtype = pieces[0].dtype
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"{fn}: the CUDA kernel takes fp32 or "
                                      f"bf16, got {dtype}")
        _check_groups(sum(p.numel() for p in pieces), groups)
        for p, d in zip(pieces, dst):
            if p.device != device or p.dtype != dtype:
                raise ValueError(f"{fn}: a leaf's pieces share one dtype and "
                                 f"every piece one device ({device})")
            if not (p.is_contiguous() and d.is_contiguous()):
                raise ValueError(f"{fn}: pieces and outputs must be "
                                 f"contiguous")
            if p.numel() and p.data_ptr() in seen:
                raise ValueError(f"{fn}: a piece appears twice in the table")
            seen.add(p.data_ptr())


def quantize_leaves(leaves, sym=True, stochastic=False, ratio=None,
                    generator=None, outs=None):
    """Grouped fake quantization of a table of leaves: ``leaves`` is
    [(pieces, bits, groups)], a leaf's groups running over the
    concatenation of its pieces (a stacked leaf: its L layer tensors in
    order); every leaf shares ``sym``, ``stochastic`` and ``ratio`` (None,
    or r of the blend r·x + (1 - r)·q). In place, or into ``outs`` (a list
    of outputs a leaf, shaped as its pieces). Returns the outputs.

    On CUDA (fp32 or bf16 pieces, contiguous): one launch of the kernel
    for the whole table (more only past MAX_TICKETS, each counted);
    stochastic rounding keys Philox by one int64 a leaf, drawn together
    from ``generator`` (None: the default CUDA generator). On the CPU:
    ``quantize_leaves_plain``."""
    fn = "quantize_leaves"
    if not leaves:
        return []
    for _, bits, _ in leaves:
        if not 1 <= bits <= 16:
            raise ValueError(f"{fn}: bits must be 1..16, got {bits}")
    device = leaves[0][0][0].device
    if device.type == "cpu":
        return quantize_leaves_plain(leaves, sym, stochastic, ratio,
                                     generator, outs)
    if device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {device}")
    plan = _plan(leaves, outs, device)
    seeds = None
    if stochastic:
        seeds = torch.randint(0, 2 ** 62, (len(leaves),), dtype=torch.int64,
                              generator=generator,
                              device=generator.device if generator is not None
                              else device).to(device)
    r = 0.0 if ratio is None else float(ratio)
    lib = builder.kernels()
    stream = torch.cuda.current_stream(device).cuda_stream
    blocks = _sm_count(device.index if device.index is not None
                       else torch.cuda.current_device()) * BLOCKS_PER_SM
    for ln in plan:
        lib.call("dstpu_quantize_leaves", ln.tiles.data_ptr(),
                 ln.tiles.numel() // TILE_DT.itemsize,
                 _leaf_params(ln, leaves, sym).data_ptr(),
                 ln.scratch.data_ptr(), ln.n_groups,
                 None if seeds is None else seeds[ln.leaf_lo:].data_ptr(),
                 int(sym), int(stochastic), int(ratio is not None),
                 float(np.float32(r)), float(np.float32(1.0 - r)), blocks,
                 stream)
        builder.launches["quantize"] += 1
    return [list(pieces) for pieces, _, _ in leaves] if outs is None \
        else outs


def quantize(x, bits=8, groups=1, sym=True, stochastic=False, generator=None,
             out=None):
    """Grouped fake quantization of x (any shape, [groups, n] flat) in
    x's dtype: ``quantize_leaves``' one-leaf case. On CUDA: fp32 or bf16,
    contiguous; ``out`` (x itself for in place, or None for a new tensor)
    receives the result."""
    fn = "quantize"
    if not 1 <= bits <= 16:
        raise ValueError(f"{fn}: bits must be 1..16, got {bits}")
    if x.device.type == "cpu":
        result = quantize_plain(x, bits, groups, sym, stochastic, generator)
        return result if out is None else out.copy_(result)
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    _check_groups(x.numel(), groups)
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{fn}: out must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    if x.numel() == 0:
        return out
    quantize_leaves([([x], bits, groups)], sym, stochastic,
                    generator=generator, outs=[[out]])
    return out
