"""The least time an NVIDIA H100 could take for a traversal wave (port of
utils/roofline.py, in Hopper terms only; the JAX module's TPU chain
calibrations have no counterpart here).

`sweep_work` counts the work a wave's rays need from the sweep kernel's
counting mode (ops/traverse_sweep.py, counters=True): one slab test per
node a ray stood on, one K-wide Möller–Trumbore per leaf it tested, plus
the bytes that must move (rays in, results out, each table read once).
`bound_seconds` turns operations and bytes into the larger of the two
times at the card's published peaks.

Operation counts per test, from csrc/traverse_sweep.cu (every FP32 add,
multiply, divide, compare, min/max and select counts as one operation):

- slab test, SLAB_OPS = 26: 6 subtracts and 6 multiplies (the slab t's),
  3 fminf and 3 fmaxf, 2 NaN-propagating max and 2 min (t_lo, t_hi), the
  clamp of t_enter at 0, and 3 compares for `enter`;
- Möller–Trumbore per triangle, MT_OPS = 57: p = d × e2 (9), det (5),
  the parallel test (2), inv_det (select and divide, 2), tv (3), u (6),
  q = tv × e1 (9), v (6), t (6), the 6 compares and 1 add of `valid`,
  and the 2 compares of the best-hit update (the warp's (t, id)
  reduction since the warp-cooperative leaf test);
- per ray once, RAY_OPS = 3: the inverse direction.
"""

from __future__ import annotations

import torch

FP32_FLOPS = 67e12    # H100 SXM, FP32 outside the tensor cores, 700 W
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
SLAB_OPS = 26
MT_OPS = 57
RAY_OPS = 3
WARP = 32
RAY_BYTES = 7 * 4  # origin, direction, t_max: f32 each


def nbytes(*tensors: torch.Tensor) -> int:
    """Bytes of the tensors (tables read, results written), each counted
    once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def sweep_work(out: dict, k: int, tables_bytes: int = 0,
               out_bytes: int | None = None) -> dict:
    """The work the rays of one wave need, from a counting-mode result
    `out` (hit_idx, t, visits, exec_windows, exec_leafs, leaf_tests) of a
    scene with K triangles per cluster. `tables_bytes`: the node and
    triangle tables the kernel reads; `out_bytes`: the results it writes
    (default: those of `out`; pass another mode's to price that mode,
    whose rays need the same tests). Returns node and
    triangle tests, FP32 operations, bytes, and two shares of the
    kernel's warp loop (the SIMT counterpart of the JAX package's volume
    efficiency):

    - `walk_useful_share` = node_tests / (32 * exec_windows): of the
      lane slots of the warp iterations, the share whose lane was still
      walking (slab-testing a node); the rest idled because their ray
      had finished while another lane of the warp walked on.
    - `useful_share` = leaf_tests / leaf_lane_slots, leaf_lane_slots =
      32 * exec_leafs: of the lanes of the iterations in which the warp
      tested leaves, the share that had entered a leaf. The warp serves
      those lanes' leaves one after another, each with one triangle slot
      a lane, so 32 * useful_share is the mean number of leaves served
      per such iteration; it no longer counts lanes left idle during a
      leaf test (with K < 32, 32 - K lanes idle in each served leaf)."""
    n = out["visits"].numel()
    node_tests = int(out["visits"].sum())
    leaf_tests = int(out["leaf_tests"].sum())
    slots = WARP * int(out["exec_leafs"].sum())
    windows = int(out["exec_windows"].sum())
    if out_bytes is None:
        out_bytes = nbytes(*out.values())
    return {
        "rays": n,
        "node_tests": node_tests,
        "leaf_tests": leaf_tests,
        "tri_tests": leaf_tests * k,
        "ops": SLAB_OPS * node_tests + MT_OPS * leaf_tests * k
        + RAY_OPS * n,
        "bytes": RAY_BYTES * n + out_bytes + tables_bytes,
        "leaf_lane_slots": slots,
        "useful_share": leaf_tests / slots if slots else 0.0,
        "walk_useful_share": node_tests / (WARP * windows) if windows
        else 0.0,
        "exec_windows": windows,
        "exec_leafs": int(out["exec_leafs"].sum()),
    }


def bound_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """max(ops / 67 TFLOP/s, bytes / 3.35 TB/s) and which term sets it:
    "operations" or "bytes"."""
    t_ops = ops / FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
