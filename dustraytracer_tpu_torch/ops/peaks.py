"""The FP32 issue-rate probe: the CUDA kernel of `csrc/peaks.cu` and its
plain version (the counterpart of the JAX package's `vpu_chain` in
utils/roofline.py::measure_peaks).

`fma_chain(x0, iters)` runs, for each element of x0, CHAINS independent
chains x_c = x0 + c * STEP, x_c <- x_c * A + B for `iters` steps, and
returns the sum of the chains, one value per element. On a CUDA tensor it
launches the kernel (one fused multiply-add per step, in float32); on a
CPU tensor it runs `fma_chain_reference`, the same chain in float64. Any
other device raises. `fma_tolerance` bounds the distance between the
two.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dustraytracer_tpu_torch.utils import profiling

A = float(np.float32(1.0000001))  # the kernel's float32 constants
B = float(np.float32(1e-7))
STEP = 2.0 ** -10
CHAINS = 8


def _check(x0) -> None:
    if not isinstance(x0, torch.Tensor) or x0.dtype != torch.float32 \
            or x0.dim() != 1 or not x0.is_contiguous():
        raise ValueError("fma_chain takes a contiguous 1-D float32 tensor")


def fma_chain_reference(x0: torch.Tensor, iters: int) -> torch.Tensor:
    """The chain in float64 on x0's device: (N,) float64."""
    _check(x0)
    x = x0.to(torch.float64)[:, None] + STEP * torch.arange(
        CHAINS, dtype=torch.float64, device=x0.device)
    for _ in range(iters):
        x.mul_(A).add_(B)
    return x.sum(dim=1)


def fma_tolerance(ref: torch.Tensor, iters: int) -> torch.Tensor:
    """Bound on |kernel - reference| per element, from float32 rounding.
    Each fmaf rounds once, by at most 2^-24 of its result, and an error
    grows by A a step, so a chain ends within iters * A^iters * 2^-24 of
    its largest value; the seven float32 adds of the sum add at most
    CHAINS * 2^-24 of the total. Every chain is positive and grows, so
    `ref` (the sum) bounds both: (iters * A^iters + CHAINS) * 2^-24 * ref,
    with 1% for the float64 reference's own rounding."""
    return 1.01 * (iters * A ** iters + CHAINS) * 2.0 ** -24 * ref.abs()


def fma_flops(n: int, iters: int) -> int:
    """FP32 operations of one launch on n elements: 2 per fmaf, one add per
    chain's start and one per chain in the sum."""
    return n * CHAINS * (2 * iters + 2)


def load_kernel():
    from dustraytracer_tpu_torch.ops.cuda_build import load_library

    lib = load_library("peaks")["lib"]
    if not getattr(lib, "_drt_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.drt_fma_peak.argtypes = [p, p, i, i, p]
        lib.drt_fma_peak.restype = ctypes.c_int
        lib.drt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.drt_cuda_error_string.restype = ctypes.c_char_p
        lib._drt_bound = True
    return lib


def fill_threads(device=None) -> int:
    """Threads that fill every SM of the card: SMs x resident threads per
    SM."""
    prop = torch.cuda.get_device_properties(device or 0)
    return prop.multi_processor_count * prop.max_threads_per_multi_processor


def fma_chain(x0: torch.Tensor, iters: int) -> torch.Tensor:
    """Sum of the CHAINS chains of each element after `iters` steps: the
    kernel in float32 on a CUDA tensor, the float64 reference (returned as
    float32) on a CPU tensor. x0 in [1, 1.5) keeps every chain's start
    exact in float32, as in the reference."""
    _check(x0)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if x0.device.type == "cpu":
        return fma_chain_reference(x0, iters).to(torch.float32)
    if x0.device.type != "cuda":
        raise ValueError(f"fma_chain: unsupported device {x0.device}")
    y = torch.empty_like(x0)
    lib = load_kernel()
    with torch.cuda.device(x0.device):
        err = lib.drt_fma_peak(x0.data_ptr(), y.data_ptr(), x0.numel(), iters,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fma_peak launch failed: "
                           f"{lib.drt_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    profiling.count("drt.launch.fma_peak")
    return y
