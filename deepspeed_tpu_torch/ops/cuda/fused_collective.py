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

Two kernels compute each GEMM on the card. Shapes TMA can describe (every
width and chunk a multiple of 8 elements, every base 16-byte aligned: all
of the main path's) take the TMA-fed wgmma kernel, walked as
``tile_plan`` lays out its tiles; the rest take the mma.sync kernel,
counted under its own launch name (``ag_matmul_mma``,
``mm_rs_partial_mma``). The choice is a shape test, not a fallback: a
kernel that fails raises.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel or
raises.
"""

import ctypes
import dataclasses
import functools

import torch

from deepspeed_tpu_torch.ops.cuda import builder

MAX_RANKS = 8
# the TMA kernel's tile: rows, k depth, and the widths it is built for
TILE_M, TILE_K = 128, 64
TILE_N_CHOICES = (256, 192, 128, 64)
# a tile's fixed cost (its epilogue, its first stages' latency) in columns
# of a tile's work, for weighing one BN's waves against another's
TILE_OVERHEAD_COLS = 32
H100_SMS = 132


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


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the TMA kernel walks one GEMM out [M, N-layout] = A @ B.

    Output tiles are ``bm`` x ``bn``; the N layout is ``chunks`` chunks of
    ``cw`` columns, each cut into ``nt_chunk`` tiles, so no tile straddles
    two chunks (the last one of a chunk that ``bn`` does not divide is
    masked). Tile ``i`` is m tile ``i % m_tiles`` of N tile ``i //
    m_tiles``; block b of ``grid`` takes tiles b, b + grid, ... The k loop
    is ``k_chunks`` contracting chunks of ``kpc`` tiles, taken in ring order
    from ``rank``'s own. Chunk c of the N layout writes at ``c * o_chunk``
    with row stride ``ldo`` (ag_matmul: column block c of [M, N]; mm_rs
    shard dim 1: slot c, [K, ck]; a single chunk: [M, N] itself)."""
    bm: int
    bn: int
    bk: int
    M: int
    m_tiles: int
    chunks: int
    cw: int
    nt_chunk: int
    k_chunks: int
    kpc: int
    a_chunk: int        # A's k offset from one contracting chunk to the next
    rank: int
    b_by_chunk: bool    # N chunk c reads B map c at local columns
    ldo: int
    o_chunk: int
    sms: int

    @property
    def tiles(self):
        return self.m_tiles * self.chunks * self.nt_chunk

    @property
    def grid(self):
        return min(self.tiles, self.sms)

    @property
    def waves(self):
        return self.tiles / self.sms

    def n_tiles(self):
        """Each N tile: (chunk, B map, B's first column, the tile's first
        column in its chunk, its columns inside the chunk)."""
        out = []
        for c in range(self.chunks):
            for j in range(self.nt_chunk):
                col = j * self.bn
                out.append((c, c if self.b_by_chunk else 0,
                            col if self.b_by_chunk else c * self.cw + col,
                            col, min(self.bn, self.cw - col)))
        return out

    def k_tiles(self):
        """Each k step in order: (contracting chunk, B map or None for
        the N tile's own, A's first k, B's first k)."""
        out = []
        for t in range(self.k_chunks * self.kpc):
            step, kt = divmod(t, self.kpc)
            kc = (self.rank - step) % self.k_chunks
            out.append((kc, kc if self.k_chunks > 1 else None,
                        kc * self.a_chunk + kt * self.bk, kt * self.bk))
        return out

    def tile(self, index):
        """(m tile, N tile index) of tile ``index``."""
        return index % self.m_tiles, index // self.m_tiles


def _pick_bn(m_tiles, chunks, cw, sms):
    """The BN whose tiles take the fewest waves of the widest work (each
    tile counted with its fixed cost); the wider on a tie."""
    def cost(bn):
        waves = _cdiv(m_tiles * chunks * _cdiv(cw, bn), sms)
        return waves * (bn + TILE_OVERHEAD_COLS), -bn
    return min(TILE_N_CHOICES, key=cost)


@functools.lru_cache(maxsize=512)
def tile_plan(kind, M, K, N, ck, n, rank=0, contract=False, shard_dim=0,
              sms=H100_SMS):
    """The TMA kernel's walk of one GEMM on a card of ``sms`` SMs. ``kind``
    "ag": x [M, K] @ B [K, N] for ``ag_matmul`` (``ck``, ``contract`` as
    ``ag_matmul_geometry`` gives them; ``rank`` starts the ring). "rs":
    lhs [M, K]^T @ rhs [M, N] for ``mm_rs_partial``, cut on ``shard_dim``
    into n slots of ``ck``. The launch reads every field."""
    if kind == "ag":
        out_rows, ldo = M, N
        if contract:
            chunks, cw, o_chunk, b_by_chunk = 1, N, 0, False
            k_chunks, kpc, a_chunk = n, _cdiv(ck, TILE_K), ck
        else:                   # one k walk: no ring to start
            chunks, cw, o_chunk, b_by_chunk = n, ck, ck, True
            k_chunks, kpc, a_chunk, rank = 1, _cdiv(K, TILE_K), 0, 0
    elif kind == "rs":
        out_rows, k_chunks, kpc, a_chunk, b_by_chunk = K, 1, \
            _cdiv(M, TILE_K), 0, False
        rank = 0
        if shard_dim == 1:      # slot c: column block c of [K, N], [K, ck]
            chunks, cw, ldo, o_chunk = N // ck, ck, ck, K * ck
        else:                   # the slots are row blocks of [K, N] itself
            chunks, cw, ldo, o_chunk = 1, N, N, 0
    else:
        raise ValueError(f"tile_plan: kind is 'ag' or 'rs', got {kind!r}")
    m_tiles = _cdiv(out_rows, TILE_M)
    bn = _pick_bn(m_tiles, chunks, cw, sms)
    return TilePlan(bm=TILE_M, bn=bn, bk=TILE_K, M=out_rows, m_tiles=m_tiles,
                    chunks=chunks, cw=cw, nt_chunk=_cdiv(cw, bn),
                    k_chunks=k_chunks, kpc=kpc, a_chunk=a_chunk, rank=rank,
                    b_by_chunk=b_by_chunk, ldo=ldo, o_chunk=o_chunk, sms=sms)


def tma_ok(widths, tensors):
    """Whether TMA can describe the operands: every width a multiple of 8
    elements (16-byte rows) and every base 16-byte aligned."""
    return all(int(v) % 8 == 0 for v in widths) and _aligned(*tensors)


def ag_matmul_route(x, shards, shard_dim, transpose_w=False):
    """The launch name ``ag_matmul`` takes for these operands:
    "ag_matmul" (the TMA kernel) or "ag_matmul_mma"."""
    K, N, ck, ldb, _, _ = ag_matmul_geometry(shards[0].shape, len(shards),
                                             shard_dim, transpose_w)
    return "ag_matmul" if tma_ok((K, N, ck, ldb), (x, *shards)) \
        else "ag_matmul_mma"


def mm_rs_partial_route(lhs, rhs, shard_dim, n, out=None):
    """The launch name ``mm_rs_partial`` takes: "mm_rs_partial" (the TMA
    kernel) or "mm_rs_partial_mma"."""
    K, N = lhs.shape[1], rhs.shape[1]
    ck = (K if shard_dim == 0 else N) // n
    tensors = (lhs, rhs) if out is None else (lhs, rhs, out)
    return "mm_rs_partial" if tma_ok((K, N, ck), tensors) \
        else "mm_rs_partial_mma"


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_tma(a, a_mn, bs, b_mn, out, plan):
    """The TMA kernel on A (``a``; ``a_mn``: read as its transpose, MN-major)
    and the B matrices ``bs`` (one tensor map each; ``b_mn``: [k, n], else
    [n, k]) along ``plan``, into ``out``."""
    builder.kernels().call(
        "dstpu_gemm_tma", a.data_ptr(), a.shape[0], a.shape[1], int(a_mn),
        _table(bs), len(bs), bs[0].shape[0], bs[0].shape[1], int(b_mn),
        out.data_ptr(), int(out.dtype == torch.float32), plan.M,
        plan.m_tiles, plan.nt_chunk, plan.cw, plan.tiles, plan.k_chunks,
        plan.kpc, plan.a_chunk, plan.rank, int(plan.b_by_chunk), plan.ldo,
        plan.o_chunk, plan.bn, plan.grid,
        torch.cuda.current_stream(a.device).cuda_stream)


def _ag_operands(fn, x, shards, shard_dim, transpose_w, out_dtype):
    """Check a CUDA call's operands; (K, N, ck, ldb, contract, b_col,
    out_dtype)."""
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
    if len(shards[0].shape) != 2:
        raise ValueError(f"{fn}: shards must be matrices")
    K, N, ck, ldb, contract, b_col = ag_matmul_geometry(
        shards[0].shape, len(shards), shard_dim, transpose_w)
    M = x.shape[0]
    if x.shape[1] != K:
        raise ValueError(f"{fn}: x has {x.shape[1]} columns; the gathered "
                         f"{'W^T' if transpose_w else 'W'} has {K} rows")
    if max(M * K, M * N, K * N) >= 2 ** 31:
        raise NotImplementedError(f"{fn}: the CUDA kernel takes operands "
                                  f"of fewer than 2^31 elements")
    return K, N, ck, ldb, contract, b_col, out_dtype


def ag_matmul(x, shards, rank, shard_dim, transpose_w=False, out_dtype=None):
    """x [M, K] @ W (or W^T), W assembled from the n ranks' ``shards``
    (rank order) inside the GEMM's tile loads; fp32 accumulation, the
    result in ``out_dtype`` (default x's). On CUDA: bf16 x and shards,
    out_dtype bf16 or fp32; the TMA kernel where ``ag_matmul_route`` says
    so, else the mma.sync kernel (counted as ``ag_matmul_mma``)."""
    if x.device.type == "cpu":
        return ag_matmul_plain(x, shards, rank, shard_dim, transpose_w,
                               out_dtype)
    return _ag_matmul_cuda("ag_matmul", x, shards, rank, shard_dim,
                           transpose_w, out_dtype)


def ag_matmul_mma(x, shards, rank, shard_dim, transpose_w=False,
                  out_dtype=None):
    """``ag_matmul`` by the mma.sync kernel, which takes any widths and
    alignment (the route of shapes TMA cannot describe)."""
    if x.device.type == "cpu":
        return ag_matmul_plain(x, shards, rank, shard_dim, transpose_w,
                               out_dtype)
    return _ag_matmul_cuda("ag_matmul_mma", x, shards, rank, shard_dim,
                           transpose_w, out_dtype)


def _ag_matmul_cuda(fn, x, shards, rank, shard_dim, transpose_w, out_dtype):
    K, N, ck, ldb, contract, b_col, out_dtype = _ag_operands(
        fn, x, shards, shard_dim, transpose_w, out_dtype)
    M, n = x.shape[0], len(shards)
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    if fn == "ag_matmul":
        fn = ag_matmul_route(x, shards, shard_dim, transpose_w)
    if fn == "ag_matmul":
        plan = tile_plan("ag", M, K, N, ck, n, int(rank), contract,
                         sms=_sms(x.device.index))
        _launch_tma(x, False, shards, not b_col, out, plan)
    else:
        vec = all(v % 8 == 0 for v in (K, N, ck, ldb)) and \
            _aligned(x, *shards)
        builder.kernels().call(
            "dstpu_ag_matmul", x.data_ptr(), _table(shards), out.data_ptr(),
            n, int(rank), M, K, N, ck, ldb, int(contract), int(b_col),
            int(out_dtype == torch.float32), int(vec),
            torch.cuda.current_stream(x.device).cuda_stream)
    builder.launches[fn] += 1
    return out


def _rs_operands(fn, lhs, rhs, shard_dim, n, out):
    """Check a CUDA call's operands; (M, K, N, ck, out)."""
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
    return M, K, N, cut // n, out


def mm_rs_partial(lhs, rhs, shard_dim, n, out=None):
    """This rank's partials of lhs^T @ rhs ([M, K] and [M, N], contracting
    over the M tokens), cut on ``shard_dim`` into n destination chunks:
    [n, shard] fp32, into ``out`` (the rank's slot region) when given. On
    CUDA: bf16 lhs and rhs; the TMA kernel where ``mm_rs_partial_route``
    says so, else the mma.sync kernel (counted as ``mm_rs_partial_mma``)."""
    if lhs.device.type == "cpu":
        result = mm_rs_partial_plain(lhs, rhs, shard_dim, n)
        return result if out is None else out.copy_(result)
    return _mm_rs_partial_cuda("mm_rs_partial", lhs, rhs, shard_dim, n, out)


def mm_rs_partial_mma(lhs, rhs, shard_dim, n, out=None):
    """``mm_rs_partial`` by the mma.sync kernel, which takes any widths and
    alignment (the route of shapes TMA cannot describe)."""
    if lhs.device.type == "cpu":
        result = mm_rs_partial_plain(lhs, rhs, shard_dim, n)
        return result if out is None else out.copy_(result)
    return _mm_rs_partial_cuda("mm_rs_partial_mma", lhs, rhs, shard_dim, n,
                               out)


def _mm_rs_partial_cuda(fn, lhs, rhs, shard_dim, n, out):
    M, K, N, ck, out = _rs_operands(fn, lhs, rhs, shard_dim, n, out)
    if M == 0:
        return out.zero_()
    if fn == "mm_rs_partial":
        fn = mm_rs_partial_route(lhs, rhs, shard_dim, n, out)
    if fn == "mm_rs_partial":
        plan = tile_plan("rs", M, K, N, ck, n, shard_dim=int(shard_dim),
                         sms=_sms(lhs.device.index))
        _launch_tma(lhs, True, [rhs], True, out, plan)
    else:
        vec = K % 8 == 0 and N % 8 == 0 and _aligned(lhs, rhs)
        builder.kernels().call(
            "dstpu_mm_rs_partial", lhs.data_ptr(), rhs.data_ptr(),
            out.data_ptr(), M, K, N, ck, int(shard_dim == 1), int(vec),
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
