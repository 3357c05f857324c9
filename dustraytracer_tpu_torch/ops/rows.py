"""The differentiable row fetch `table[idx]` (dim 0) with a deterministic
backward: K4, the CUDA kernels of `csrc/rows_grad.cu`, and their plain
PyTorch versions.

`gather_rows(table, idx)` is `table.index_select(0, idx)` forward, bit
for bit. Its backward, `rows_grad(grad, idx, n_rows)`, adds each row's
cotangents: on a CUDA tensor by the kernels, in an order fixed by (idx,
lane) and the shapes alone and with no floating-point atomics, so two
backward passes on equal inputs give equal bits; on a CPU tensor by
`rows_grad_reference`, `index_add_` into zeros, which runs sequentially
there. Any other device raises. (The library backward of index_select on
the card is an atomic index_add_, whose order of float adds changes from
run to run.)

The kernels have two instances, chosen by the shapes alone:

- plan-free, for n_rows * C <= SMALL_SLOTS (the material table): fixed
  tiles of lanes, each thread adding its (row, column) slot over its lane
  group in lane order, then the tiles in tile order. `rows_grad_small_replay`
  replays that order on the CPU.
- planned, for every other shape: hand-written plan kernels sort the lanes
  stably by id (a radix sort over the bits the ids use) into `perm` and
  each row's run `starts`, equal as integers to `plan`, the plain
  PyTorch plan; the runs are cut into chunks of CHUNK sorted lanes, each
  summed in lane order, then each row's chunks in a fixed order.

Nothing reads a value back to the host, so a CUDA graph can capture a
call. The kernels take the cotangent's row stride: a column slice of the
fetched rows needs no copy.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from dustraytracer_tpu_torch.utils import profiling

# Layout constants; csrc/rows_grad.cu's must equal them (load_kernel checks)
CHUNK = 128            # sorted lanes per chunk: the planned sum's first level
SORT_TILE = 2048       # lanes per block of a radix pass
SMALL_SLOTS = 64       # n_rows * C at most for the plan-free instance
SMALL_TILE = 128       # lanes a block stages at a time (plan-free)
SMALL_BLOCK = 128      # threads a block (plan-free)
SMALL_MAX_BLOCKS = 1024
CONSTANTS = (CHUNK, SORT_TILE, SMALL_SLOTS, SMALL_TILE, SMALL_BLOCK,
             SMALL_MAX_BLOCKS)
# the kernels of csrc/rows_grad.cu, in drt_rows_grad_occupancy's order
KERNELS = ("hist_i64", "hist_i32", "scan", "scatter_i64", "scatter_i32",
           "starts", "heads", "chunks", "rows", "tiles", "tile_sum")


def rows_grad_reference(grad: torch.Tensor, idx: torch.Tensor,
                        n_rows: int) -> torch.Tensor:
    """The plain twin: zeros (n_rows, *grad.shape[1:]) index_add_ (0, idx,
    grad), in grad's dtype on grad's device."""
    out = grad.new_zeros((n_rows, *grad.shape[1:]))
    return out.index_add_(0, idx, grad)


def is_small(n_rows: int, cols: int) -> bool:
    """Whether the plan-free instance takes a table of this shape."""
    return n_rows * cols <= SMALL_SLOTS


def max_chunks(n: int, n_rows: int) -> int:
    """The chunk slots of n lanes into n_rows rows: row r's chunks take
    the slots from starts[r] // CHUNK + r on, all below this bound, known
    without reading the plan back."""
    return -(-n // CHUNK) + n_rows


def max_multi(n: int, n_rows: int) -> int:
    """An upper bound on the rows of more than one chunk."""
    return min(n_rows, n // (CHUNK + 1))


def plan(idx: torch.Tensor, n_rows: int, chunk: int = CHUNK):
    """The planned instance's order for ids `idx` (N,), int32 or int64,
    into n_rows rows, by plain PyTorch calls: (perm, starts, first_slot,
    max_chunks), the first three int32. perm (N,) sorts idx stably; row
    r's sorted lanes are perm[starts[r]:starts[r+1]], cut into
    ceil(run / chunk) chunks that take the slots from first_slot[r] =
    starts[r] // chunk + r on (slots of different rows never overlap);
    every slot lies below max_chunks. The plan kernels' perm and starts
    equal these."""
    n = idx.shape[0]
    sorted_idx, perm = torch.sort(idx.to(torch.int32), stable=True)
    starts = torch.searchsorted(
        sorted_idx, torch.arange(n_rows + 1, dtype=torch.int32,
                                 device=idx.device), out_int32=True)
    first_slot = starts[:-1] // chunk + torch.arange(
        n_rows, dtype=torch.int32, device=idx.device)
    return perm.to(torch.int32), starts, first_slot, -(-n // chunk) + n_rows


def sort_ints(n: int) -> int:
    """Workspace ints of the radix sort of n ids: keys and lane numbers
    twice, each block's digit histogram and the digit totals."""
    return 4 * n + 256 * (-(-n // SORT_TILE) + 1)


def plan_ints(n: int, n_rows: int) -> int:
    """Workspace ints of the planned instance: the sort's, perm, starts,
    the chunk slots' rows, the multi-chunk rows and their counter."""
    return (sort_ints(n) + n + n_rows + 1 + max_chunks(n, n_rows)
            + max_multi(n, n_rows) + 1)


def small_layout(n: int) -> tuple[int, int]:
    """(lanes per block, blocks) of the plan-free instance for n lanes:
    fixed by n alone."""
    tiles = -(-n // SMALL_TILE)
    blocks = min(tiles, SMALL_MAX_BLOCKS)
    per_block = -(-tiles // blocks) * SMALL_TILE
    return per_block, -(-n // per_block)


def rows_grad_small_replay(grad: torch.Tensor, idx: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """The plan-free instance's order, replayed in grad's dtype (float64
    in the tests): block b takes lanes [b * per_block, ...); in it, slot
    (r, c) of lane group g adds, tile after tile, the lanes of the group's
    fixed sub-range whose id is r, in lane order; the groups are added in
    group order; then lane l of a warp adds blocks l, l + 32, ... and a
    shuffle tree (16, 8, 4, 2, 1) adds the lanes. Not used on the main
    path."""
    n, cols = grad.shape
    if n == 0:
        return grad.new_zeros((n_rows, cols))
    slots = n_rows * cols
    if slots > SMALL_SLOTS:
        raise ValueError(f"{n_rows} x {cols} is past the plan-free limit")
    groups = SMALL_BLOCK // slots
    per_block, blocks = small_layout(n)
    dev = grad.device
    g_lo = torch.tensor([g * SMALL_TILE // groups for g in range(groups)],
                        device=dev)
    g_hi = torch.tensor([(g + 1) * SMALL_TILE // groups
                         for g in range(groups)], device=dev)
    b_lo = torch.arange(blocks, device=dev) * per_block
    b_hi = torch.clamp(b_lo + per_block, max=n)
    rows = torch.arange(n_rows, device=dev)
    acc = grad.new_zeros((blocks, groups, n_rows, cols))
    for tile in range(0, per_block, SMALL_TILE):
        for q in range(-(-SMALL_TILE // groups)):
            lane = b_lo[:, None] + tile + g_lo[None, :] + q  # (blocks, groups)
            ok = (g_lo[None, :] + q < g_hi[None, :]) & (lane < b_hi[:, None])
            safe = torch.where(ok, lane, 0)
            hit = (idx[safe][..., None] == rows) & ok[..., None]
            acc = acc + torch.where(hit[..., None], grad[safe][:, :, None, :],
                                    grad.new_zeros(()))
    partial = acc[:, 0]
    for g in range(1, groups):
        partial = partial + acc[:, g]
    lanes = grad.new_zeros((32, n_rows, cols))
    for b0 in range(0, blocks, 32):
        part = partial[b0:b0 + 32]
        lanes[:part.shape[0]] = lanes[:part.shape[0]] + part
    for off in (16, 8, 4, 2, 1):
        lanes[:off] = lanes[:off] + lanes[off:2 * off]
    return lanes[0].clone()


def load_kernel():
    from dustraytracer_tpu_torch.ops.cuda_build import load_library

    lib = load_library("rows_grad")["lib"]
    if not getattr(lib, "_drt_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.drt_rows_grad_constants.argtypes = [p]
        lib.drt_rows_grad_constants.restype = None
        lib.drt_rows_grad_plan.argtypes = [p, i, i, p, p, p, p]
        lib.drt_rows_grad_planned.argtypes = [p, ll, p, p, p, p, i, i, i, i,
                                              i, p]
        lib.drt_rows_grad_small.argtypes = [p, ll, p, p, p, i, i, i, i, p]
        lib.drt_rows_grad_occupancy.argtypes = [p]
        for fn in (lib.drt_rows_grad_plan, lib.drt_rows_grad_planned,
                   lib.drt_rows_grad_small, lib.drt_rows_grad_occupancy):
            fn.restype = ctypes.c_int
        lib.drt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.drt_cuda_error_string.restype = ctypes.c_char_p
        got = (ctypes.c_int * len(CONSTANTS))()
        lib.drt_rows_grad_constants(got)
        if tuple(got) != CONSTANTS:
            raise RuntimeError(f"csrc/rows_grad.cu's constants {tuple(got)} "
                               f"differ from ops/rows.py's {CONSTANTS}")
        lib._drt_bound = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"rows_grad {what} failed: "
                           f"{lib.drt_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")


def occupancy() -> dict:
    """Resident blocks per SM of each kernel of csrc/rows_grad.cu on the
    current card (the CUDA occupancy calculator's figure)."""
    lib = load_kernel()
    out = (ctypes.c_int * len(KERNELS))()
    _raise_on(lib, lib.drt_rows_grad_occupancy(out), "occupancy query")
    return dict(zip(KERNELS, out))


def _check_ids(idx: torch.Tensor, n: int) -> None:
    if idx.dim() != 1 or idx.dtype != torch.int64 or idx.shape[0] != n:
        raise ValueError(f"rows_grad: idx must be (N,) int64 and grad "
                         f"(N, ...), got {tuple(idx.shape)} {idx.dtype} "
                         f"and N = {n}")


def plan_kernel(idx: torch.Tensor, n_rows: int):
    """The plan kernels' (perm, starts), int32 on idx's CUDA device: the
    planned instance's first launches, equal as integers to plan()'s.
    rows_grad launches them itself; this entry is for checking them."""
    n = idx.shape[0]
    _check_ids(idx, n)
    if idx.device.type != "cuda":
        raise ValueError(f"plan_kernel: a CUDA tensor, got {idx.device}")
    if not 0 < n < 2**31 or not 0 < n_rows < 2**31:
        raise ValueError(f"plan_kernel: N = {n}, n_rows = {n_rows}")
    idx = idx.contiguous()
    lib = load_kernel()
    ws = torch.empty(sort_ints(n), dtype=torch.int32, device=idx.device)
    perm = torch.empty(n, dtype=torch.int32, device=idx.device)
    starts = torch.empty(n_rows + 1, dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        _raise_on(lib, lib.drt_rows_grad_plan(
            idx.data_ptr(), n, n_rows, ws.data_ptr(), perm.data_ptr(),
            starts.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "plan launch")
    return perm, starts


def rows_grad(grad: torch.Tensor, idx: torch.Tensor,
              n_rows: int) -> torch.Tensor:
    """d table of out = table.index_select(0, idx), from out's cotangent
    `grad` (N, C): (n_rows, C). The kernels on a CUDA tensor (float32; ids
    must lie in [0, n_rows), as index_select checked them; any row stride
    with unit column stride), the twin on a CPU tensor."""
    _check_ids(idx, grad.shape[0] if grad.dim() else -1)
    if grad.device.type == "cpu":
        return rows_grad_reference(grad, idx, n_rows)
    if grad.device.type != "cuda":
        raise ValueError(f"rows_grad: unsupported device {grad.device}")
    if grad.dtype != torch.float32 or grad.dim() != 2:
        raise ValueError(f"rows_grad: the kernel takes (N, C) float32, got "
                         f"{tuple(grad.shape)} {grad.dtype}")
    n, cols = grad.shape
    if n == 0 or n_rows == 0 or cols == 0:
        return grad.new_zeros((n_rows, cols))
    if n >= 2**31 or n_rows >= 2**31:
        raise ValueError(f"rows_grad: N = {n}, n_rows = {n_rows} past int32")
    if grad.stride(1) != 1 or grad.stride(0) < cols:
        grad = grad.contiguous()
    ld = grad.stride(0)
    idx = idx.contiguous()
    out = grad.new_empty((n_rows, cols))
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    lib = load_kernel()
    if is_small(n_rows, cols):
        per_block, blocks = small_layout(n)
        partial = grad.new_empty(blocks * n_rows * cols)
        with torch.cuda.device(grad.device):
            err = lib.drt_rows_grad_small(
                grad.data_ptr(), ld, idx.data_ptr(), partial.data_ptr(),
                out.data_ptr(), n, n_rows, cols, per_block, stream)
        _raise_on(lib, err, "launch")
    else:
        chunks, multi = max_chunks(n, n_rows), max_multi(n, n_rows)
        ws = torch.empty(plan_ints(n, n_rows), dtype=torch.int32,
                         device=grad.device)
        partial = grad.new_empty(chunks * cols)
        with torch.cuda.device(grad.device):
            err = lib.drt_rows_grad_planned(
                grad.data_ptr(), ld, idx.data_ptr(), ws.data_ptr(),
                partial.data_ptr(), out.data_ptr(), n, n_rows, cols, chunks,
                multi, stream)
        _raise_on(lib, err, "launch")
    profiling.count("drt.launch.k4")
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        with profiling.span("drt.bwd.rows"):
            (idx,) = ctx.saved_tensors
            return rows_grad(grad, idx, ctx.n_rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table.index_select(0, idx) (ids cast to int64), differentiable in
    `table` through rows_grad."""
    return _GatherRows.apply(table, idx.to(torch.int64))
