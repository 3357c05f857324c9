"""The differentiable row fetch `table[idx]` (dim 0) with a deterministic
backward: K4, the CUDA kernel of `csrc/rows_grad.cu`, and its plain
PyTorch twin.

`gather_rows(table, idx)` is `table.index_select(0, idx)` forward, bit
for bit. Its backward, `rows_grad(grad, idx, n_rows)`, adds each row's
cotangents: on a CUDA tensor by the kernel, in an order fixed by (idx,
lane) and the shapes alone and with no floating-point atomics, so two
backward passes on equal inputs give equal bits; on a CPU tensor by
`rows_grad_reference`, `index_add_` into zeros, which runs sequentially
there. Any other device raises. (The library backward of index_select on
the card is an atomic index_add_, whose order of float adds changes from
run to run.)

The kernel's order is planned here (`plan`): a stable sort of idx, each
row's run of sorted lanes, and the runs cut into chunks of CHUNK lanes.
The kernel sums each chunk in lane order, then each row's chunks in
chunk order (csrc/rows_grad.cu).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

CHUNK = 128  # sorted lanes per chunk: the first level of the kernel's sum
LAUNCHES = 0  # kernel launches since import (or since a caller reset it)


def rows_grad_reference(grad: torch.Tensor, idx: torch.Tensor,
                        n_rows: int) -> torch.Tensor:
    """The plain twin: zeros (n_rows, *grad.shape[1:]) index_add_ (0, idx,
    grad), in grad's dtype on grad's device."""
    out = grad.new_zeros((n_rows, *grad.shape[1:]))
    return out.index_add_(0, idx, grad)


def plan(idx: torch.Tensor, n_rows: int, chunk: int = CHUNK):
    """The kernel's summation order for int64 ids `idx` (N,) into n_rows
    rows: (perm, starts, chunk_off, max_chunks). perm (N,) sorts idx
    stably; row r's sorted lanes are perm[starts[r]:starts[r+1]], cut into
    ceil(run / chunk) chunks numbered from chunk_off[r]; max_chunks bounds
    chunk_off[n_rows] without reading it back. Integer ops only, none of
    which makes the host wait for the card."""
    n = idx.shape[0]
    sorted_idx, perm = torch.sort(idx, stable=True)
    starts = torch.searchsorted(
        sorted_idx, torch.arange(n_rows + 1, dtype=torch.int64,
                                 device=idx.device))
    per_row = (starts[1:] - starts[:-1] + chunk - 1) // chunk
    chunk_off = torch.cat([starts.new_zeros(1), torch.cumsum(per_row, 0)])
    max_chunks = min(n, -(-n // chunk) + n_rows)
    return perm, starts, chunk_off, max_chunks


def load_kernel():
    from dustraytracer_tpu_torch.ops.cuda_build import load_library

    lib = load_library("rows_grad")["lib"]
    if not getattr(lib, "_drt_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.drt_rows_grad.argtypes = [p, p, p, p, p, p, i, i, i,
                                      ctypes.c_longlong, p]
        lib.drt_rows_grad.restype = ctypes.c_int
        lib.drt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.drt_cuda_error_string.restype = ctypes.c_char_p
        lib._drt_bound = True
    return lib


def rows_grad(grad: torch.Tensor, idx: torch.Tensor,
              n_rows: int) -> torch.Tensor:
    """d table of out = table.index_select(0, idx), from out's cotangent
    `grad` (N, C): (n_rows, C). The kernel on a CUDA tensor (float32; ids
    must lie in [0, n_rows), as index_select checked them), the twin on a
    CPU tensor."""
    global LAUNCHES
    if idx.dim() != 1 or idx.dtype != torch.int64 \
            or grad.shape[0] != idx.shape[0]:
        raise ValueError(f"rows_grad: idx must be (N,) int64 and grad "
                         f"(N, ...), got {tuple(idx.shape)} {idx.dtype} "
                         f"and {tuple(grad.shape)}")
    if grad.device.type == "cpu":
        return rows_grad_reference(grad, idx, n_rows)
    if grad.device.type != "cuda":
        raise ValueError(f"rows_grad: unsupported device {grad.device}")
    if grad.dtype != torch.float32 or grad.dim() != 2:
        raise ValueError(f"rows_grad: the kernel takes (N, C) float32, got "
                         f"{tuple(grad.shape)} {grad.dtype}")
    grad = grad.contiguous()  # slices of the fetched rows arrive strided
    cols = grad.shape[1]
    out = grad.new_empty((n_rows, cols))
    perm, starts, chunk_off, max_chunks = plan(idx, n_rows)
    partial = grad.new_empty((max(max_chunks, 1), cols))
    lib = load_kernel()
    with torch.cuda.device(grad.device):
        err = lib.drt_rows_grad(
            grad.data_ptr(), perm.data_ptr(), starts.data_ptr(),
            chunk_off.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n_rows, cols, CHUNK, max_chunks,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rows_grad launch failed: "
                           f"{lib.drt_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    LAUNCHES += 1
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
        (idx,) = ctx.saved_tensors
        return rows_grad(grad, idx, ctx.n_rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table.index_select(0, idx) (ids cast to int64), differentiable in
    `table` through rows_grad."""
    return _GatherRows.apply(table, idx.to(torch.int64))
