"""All-gather+matmul and matmul+reduce-scatter over the n ranks' shards:
the CUDA kernels (csrc/fused_collective.cu) and their plain PyTorch
versions.

Replace ``deepspeed_tpu/ops/pallas/fused_collective.py``:
``_ag_matmul_fused`` (:299) as ``ag_matmul``, and ``_mm_rs_fused`` (:491)
as ``mm_rs_partial`` followed, after a barrier, by ``mm_rs_reduce``. The
contract is the pointer table: a function takes the list of the n ranks'
shards in rank order, as this process sees them (its own tensor and the
peers' views of the symmetric heap on the card; gathered copies over gloo
on the CPU). The plain versions follow JAX's ``backend="lax"`` schedule
(``_ag_matmul_lax`` :204, ``_mm_rs_lax`` :245): per-chunk fp32 products,
the contracting chunks summed in ring order from the rank's own, and the
reduce-scatter summed from the partial born on rank k+1 to rank k's own.

W is [in, out]; a shard cuts ``shard_dim`` into n equal chunks. ``x @ W``
(or ``x @ W^T`` with ``transpose_w``) contracts over the chunks when
``(shard_dim == 0) != transpose_w`` and assembles output column blocks
otherwise.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops.cuda import builder

MAX_RANKS = 8


def contracting(shard_dim, transpose_w):
    """Whether the chunks of a ``shard_dim`` shard contract (y += x[:, c] @
    W_c) rather than give output column blocks."""
    return (int(shard_dim) == 0) != bool(transpose_w)


def _b_chunk(shard, transpose_w):
    w = shard.float()
    return w.t() if transpose_w else w


def ag_matmul_plain(x, shards, rank, shard_dim, transpose_w=False,
                    out_dtype=None):
    """x [M, K] @ W (or W^T) with W the concatenation of ``shards`` on
    ``shard_dim``, in fp32, in ``_ag_matmul_lax``'s order; the result in
    ``out_dtype`` (default x's)."""
    out_dtype = out_dtype or x.dtype
    n = len(shards)
    xf = x.float()
    if contracting(shard_dim, transpose_w):
        ck = shards[0].shape[1] if transpose_w else shards[0].shape[0]
        acc = None
        for s in range(n):
            c = (rank - s) % n
            part = xf[:, c * ck:(c + 1) * ck] @ _b_chunk(shards[c],
                                                        transpose_w)
            acc = part if acc is None else acc + part
        return acc.to(out_dtype)
    blocks = [None] * n
    for s in range(n):
        c = (rank - s) % n
        blocks[c] = (xf @ _b_chunk(shards[c], transpose_w)).to(out_dtype)
    return torch.cat(blocks, dim=1)


def mm_rs_partial_plain(lhs, rhs, shard_dim, n):
    """This rank's partials [n, shard] fp32: row c is chunk c of lhs^T @
    rhs (lhs [M, K], rhs [M, N]) cut on ``shard_dim``, each its own fp32
    product as ``_mm_rs_lax`` makes it."""
    lf, rf = lhs.float(), rhs.float()
    if shard_dim == 0:
        ck = lhs.shape[1] // n
        parts = [lf[:, c * ck:(c + 1) * ck].t() @ rf for c in range(n)]
    else:
        ck = rhs.shape[1] // n
        parts = [lf.t() @ rf[:, c * ck:(c + 1) * ck] for c in range(n)]
    return torch.stack([p.reshape(-1) for p in parts])


def mm_rs_reduce_plain(slots, rank):
    """Chunk ``rank`` summed over the n ranks' partials (``slots``, each
    [n, shard] fp32, in rank order): rank+1's first, this rank's last."""
    n = len(slots)
    acc = slots[(rank + 1) % n][rank].float().clone()
    for j in range(2, n + 1):
        acc = acc + slots[(rank + j) % n][rank].float()
    return acc


def _table(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_peers(fn, tensors, dtype, device):
    n = len(tensors)
    if not 1 <= n <= MAX_RANKS:
        raise NotImplementedError(f"{fn}: the CUDA kernel takes 1 to "
                                  f"{MAX_RANKS} ranks, got {n}")
    shape = tuple(tensors[0].shape)
    for t in tensors:
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: every rank's tensor must be a "
                             f"contiguous {dtype} {shape} on {device}")


def ag_matmul_geometry(shard_shape, n, shard_dim, transpose_w):
    """(K, N, ck, ldb, contracting, b_col) of the kernel's GEMM for a
    shard of ``shard_shape``: B is W or W^T, [K, N]; ``ck`` the chunk
    width; ``ldb`` a shard's row stride; ``b_col`` whether B is read
    transposed (k contiguous)."""
    R, C = shard_shape
    contract = contracting(shard_dim, transpose_w)
    if not transpose_w:
        if shard_dim == 0:        # [in/n, out]: rows of W
            return n * R, C, R, C, contract, False
        return R, n * C, C, C, contract, False      # [in, out/n]: columns
    if shard_dim == 0:            # W^T's columns are W's rows
        return C, n * R, R, C, contract, True
    return n * C, R, C, C, contract, True           # W^T's rows: W's columns


def ag_matmul(x, shards, rank, shard_dim, transpose_w=False, out_dtype=None):
    """x [M, K] @ W (or W^T), W assembled from the n ranks' ``shards``
    (rank order) inside the GEMM's tile loads; fp32 accumulation, the
    result in ``out_dtype`` (default x's). On CUDA: bf16 x and shards,
    out_dtype bf16 or fp32."""
    fn = "ag_matmul"
    if x.device.type == "cpu":
        return ag_matmul_plain(x, shards, rank, shard_dim, transpose_w,
                               out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    if x.dtype != torch.bfloat16 or out_dtype not in (torch.bfloat16,
                                                      torch.float32):
        raise NotImplementedError(f"{fn}: the CUDA kernel takes bf16 x and "
                                  f"shards and gives bf16 or fp32, got "
                                  f"{x.dtype} -> {out_dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{fn}: x must be a contiguous [M, K] matrix")
    _check_peers(fn, shards, torch.bfloat16, x.device)
    n = len(shards)
    if len(shards[0].shape) != 2:
        raise ValueError(f"{fn}: shards must be matrices")
    K, N, ck, ldb, contract, b_col = ag_matmul_geometry(
        shards[0].shape, n, shard_dim, transpose_w)
    M = x.shape[0]
    if x.shape[1] != K:
        raise ValueError(f"{fn}: x has {x.shape[1]} columns; the gathered "
                         f"{'W^T' if transpose_w else 'W'} has {K} rows")
    if max(M * K, M * N, K * N) >= 2 ** 31:
        raise NotImplementedError(f"{fn}: the CUDA kernel takes operands "
                                  f"of fewer than 2^31 elements")
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    vec = all(v % 8 == 0 for v in (K, N, ck, ldb)) and _aligned(x, *shards)
    builder.kernels().call(
        "dstpu_ag_matmul", x.data_ptr(), _table(shards), out.data_ptr(), n,
        int(rank), M, K, N, ck, ldb, int(contract), int(b_col),
        int(out_dtype == torch.float32), int(vec),
        torch.cuda.current_stream(x.device).cuda_stream)
    builder.launches[fn] += 1
    return out


def mm_rs_partial(lhs, rhs, shard_dim, n, out=None):
    """This rank's partials of lhs^T @ rhs ([M, K] and [M, N], contracting
    over the M tokens), cut on ``shard_dim`` into n destination chunks:
    [n, shard] fp32, into ``out`` (the rank's slot region) when given. On
    CUDA: bf16 lhs and rhs."""
    fn = "mm_rs_partial"
    if lhs.device.type == "cpu":
        result = mm_rs_partial_plain(lhs, rhs, shard_dim, n)
        return result if out is None else out.copy_(result)
    if lhs.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {lhs.device}")
    if lhs.dtype != torch.bfloat16 or rhs.dtype != torch.bfloat16:
        raise NotImplementedError(f"{fn}: the CUDA kernel takes bf16 "
                                  f"operands, got {lhs.dtype}, {rhs.dtype}")
    if lhs.dim() != 2 or rhs.dim() != 2 or lhs.shape[0] != rhs.shape[0] \
            or not lhs.is_contiguous() or not rhs.is_contiguous() \
            or rhs.device != lhs.device:
        raise ValueError(f"{fn}: lhs [M, K] and rhs [M, N] must be "
                         f"contiguous matrices on one device")
    M, K = lhs.shape
    N = rhs.shape[1]
    cut = K if shard_dim == 0 else N
    if cut % n:
        raise ValueError(f"{fn}: dim {cut} does not split into {n} chunks")
    if max(M * K, M * N, K * N) >= 2 ** 31:
        raise NotImplementedError(f"{fn}: the CUDA kernel takes operands "
                                  f"of fewer than 2^31 elements")
    shard = K * N // n
    if out is None:
        out = torch.empty(n, shard, dtype=torch.float32, device=lhs.device)
    elif out.dtype != torch.float32 or out.numel() != n * shard \
            or not out.is_contiguous() or out.device != lhs.device:
        raise ValueError(f"{fn}: out must be a contiguous fp32 [{n}, "
                         f"{shard}] on {lhs.device}")
    if M == 0:
        return out.zero_()
    vec = K % 8 == 0 and N % 8 == 0 and _aligned(lhs, rhs)
    builder.kernels().call(
        "dstpu_mm_rs_partial", lhs.data_ptr(), rhs.data_ptr(),
        out.data_ptr(), M, K, N, cut // n, int(shard_dim == 1), int(vec),
        torch.cuda.current_stream(lhs.device).cuda_stream)
    builder.launches[fn] += 1
    return out


def mm_rs_reduce(slots, rank, out=None):
    """Chunk ``rank`` summed over the n ranks' partials (``slots``, each
    [n, shard] fp32, rank order; the peers' views of their slot regions on
    the card): [shard] fp32."""
    fn = "mm_rs_reduce"
    if slots[0].device.type == "cpu":
        result = mm_rs_reduce_plain(slots, rank)
        return result if out is None else out.copy_(result)
    if slots[0].device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {slots[0].device}")
    _check_peers(fn, slots, torch.float32, slots[0].device)
    n = len(slots)
    if slots[0].shape[0] != n:
        raise ValueError(f"{fn}: each slot region must be [{n}, shard]")
    shard = slots[0][0].numel()
    if out is None:
        out = torch.empty(shard, dtype=torch.float32, device=slots[0].device)
    elif out.dtype != torch.float32 or out.numel() != shard \
            or not out.is_contiguous():
        raise ValueError(f"{fn}: out must be a contiguous fp32 [{shard}]")
    vec = shard % 4 == 0 and _aligned(out, *slots)
    builder.kernels().call(
        "dstpu_mm_rs_reduce", _table(slots), out.data_ptr(), shard,
        int(rank), n, int(vec),
        torch.cuda.current_stream(out.device).cuda_stream)
    builder.launches[fn] += 1
    return out
