"""Base-threading cluster-BVH traversal: the CUDA kernel and its plain
PyTorch twin (port of ops/traverse_pallas.py, whose name it keeps so a
reader finds the counterpart; there is no Pallas in it).

`traverse_cluster_pallas` launches `csrc/traverse_pallas.cu` on CUDA
tensors and runs `traverse_cluster_pallas_reference` on CPU tensors; any
other device raises. Both follow the JAX package's one-hot kernel rules
per ray: walk the base pre-order threading of the cluster BVH (no octant
orders), enter a node where the slab test hits and t_enter < hit_t, at
an entered leaf take the smallest Möller–Trumbore t (ties to the lowest
triangle id) and commit it only if it improves t and the id is real;
any-hit ends a ray at its first commit; at most 2 * n_nodes + 4 steps.
They return detached {"hit_idx" i32 (-1 = miss), "t" f32 (t_max on a
miss), "visits" i32 zeros}: the TPU kernel tracks no visits.

The kernel has two instances (`NODE_TABLES`): "shared" stages a node
table of at most 1,024 nodes in each block's shared memory, "global"
reads the nodes through the read-only cache. The source's limit picks
one; `traverse_cluster_pallas_global` forces "global" on any table, and
`launch_config` reports what a launch runs.
"""

from __future__ import annotations

import ctypes

import torch

from dustraytracer_tpu_torch.accel.cluster import ClusterBvh
from dustraytracer_tpu_torch.ops.traverse_sweep import (BIG, _check_rays,
                                                        _t_init, cluster_mt,
                                                        device_tables,
                                                        slab_enter)

_NO_ID = 2 ** 30
MAX_STEPS_FACTOR = 2  # the TPU kernel's bound: 2 * n_nodes + 4 steps

# kernel launches since import (or since a caller reset them), of either
# instance; the twin never counts
LAUNCHES = 0
# the kernel's instances: node table in shared memory, or read through
# the read-only cache (csrc/traverse_pallas.cu, point 4)
NODE_TABLES = ("shared", "global")


def _max_steps(cb: ClusterBvh) -> int:
    return MAX_STEPS_FACTOR * max(cb.n_nodes, 1) + 4


@torch.no_grad()
def traverse_cluster_pallas_reference(cb: ClusterBvh, origin, direction, *,
                                      anyhit: bool = False, t_max=None):
    """Plain PyTorch twin of the CUDA kernel: a lockstep per-lane walk of
    the base threading, each step gathering the live lanes' node rows
    and running a K-wide Möller–Trumbore on the (L, K) cluster rows of
    the lanes that entered a leaf. Operations are in the kernel's order,
    one rounding each, so on the card the two agree bit for bit."""
    _check_rays(cb, origin, direction)
    n = origin.shape[0]
    dev = origin.device
    box_lo, box_hi = cb.node_min, cb.node_max
    skip_t = cb.node_skip.to(torch.int64)
    clus_t = cb.node_cluster.to(torch.int64)

    hit_t = _t_init(t_max, n, dev).clone()
    hit_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lanes = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    inv_dir = 1.0 / direction

    for _ in range(_max_steps(cb)):
        if not lanes.numel():
            break
        lo, hi = box_lo[node], box_hi[node]
        skip, cluster = skip_t[node], clus_t[node]
        cur_t = hit_t[lanes]
        enter = slab_enter(lo, hi, origin[lanes], inv_dir[lanes], cur_t)
        is_leaf = cluster >= 0
        nxt = torch.where(enter & ~is_leaf, node + 1, skip)

        at_leaf = torch.nonzero(enter & is_leaf).squeeze(1)
        if at_leaf.numel():
            ll = lanes[at_leaf]
            cl = cluster[at_leaf]
            tri_id = cb.tri_idx[cl]                        # (L, K)
            par, u, v, tt = cluster_mt(cb, cl, origin[ll], direction[ll])
            leaf_t = cur_t[at_leaf][:, None]
            # no id test here: padding slots are degenerate, and the
            # commit rejects a negative id
            valid = (~par) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) \
                & (u + v <= 1.0) & (tt > 1e-6) & (tt < leaf_t)
            t_masked = torch.where(valid, tt, BIG)
            best_t = t_masked.amin(dim=1)
            is_best = valid & (t_masked <= best_t[:, None])
            best_id = torch.where(is_best, tri_id, _NO_ID).amin(dim=1)
            improve = (best_t < leaf_t[:, 0]) & (best_id >= 0) \
                & (best_id < _NO_ID)
            won = at_leaf[improve]
            hit_t[lanes[won]] = best_t[improve]
            hit_idx[lanes[won]] = best_id[improve]
            if anyhit:
                nxt[won] = -1

        live = nxt >= 0
        lanes, node = lanes[live], nxt[live]

    return {"hit_idx": hit_idx, "t": hit_t,
            "visits": torch.zeros((n,), dtype=torch.int32, device=dev)}


def load_kernel():
    """Load the kernel library, declaring every entry's C signature."""
    from dustraytracer_tpu_torch.ops.cuda_build import load_library

    lib = load_library("traverse_pallas")["lib"]
    if not getattr(lib, "_drt_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.drt_traverse_pallas, lib.drt_traverse_pallas_global):
            fn.argtypes = [p, p, p, i, p, i, i, p, i, i, p, p, p, p]
            fn.restype = ctypes.c_int
        lib.drt_traverse_pallas_occupancy.argtypes = [
            ctypes.POINTER(ctypes.c_int)]
        lib.drt_traverse_pallas_occupancy.restype = ctypes.c_int
        lib.drt_traverse_pallas_launch_config.argtypes = [
            i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.drt_traverse_pallas_launch_config.restype = ctypes.c_int
        lib.drt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.drt_cuda_error_string.restype = ctypes.c_char_p
        lib._drt_bound = True
    return lib


def _raise_on(lib, err: int, what: str):
    if err != 0:
        msg = lib.drt_cuda_error_string(err).decode()
        raise RuntimeError(f"traverse_pallas {what} failed: {msg} "
                           f"(cudaError {err})")


def occupancy() -> int:
    """Resident blocks per SM of the "global" instance on the current card
    (the CUDA occupancy calculator's figure)."""
    lib = load_kernel()
    blocks = ctypes.c_int(0)
    _raise_on(lib, lib.drt_traverse_pallas_occupancy(ctypes.byref(blocks)),
              "occupancy query")
    return blocks.value


def launch_config(cb: ClusterBvh, n: int, node_table: str | None = None
                  ) -> dict:
    """What a launch of n rays on `cb`'s base threading runs on the
    current card: {"node_table": "shared" or "global", "blocks_per_sm",
    "grid", "shared_bytes" (dynamic shared memory per block)}.
    node_table=None is the source's rule (what traverse_cluster_pallas
    runs), "global" what traverse_cluster_pallas_global runs."""
    if node_table not in (None, "global"):
        raise ValueError(f"node_table must be None or 'global', got "
                         f"{node_table!r}")
    lib = load_kernel()
    out = (ctypes.c_int * 4)()
    _raise_on(lib, lib.drt_traverse_pallas_launch_config(
        n, cb.n_nodes, int(node_table == "global"), out), "launch plan")
    return {"node_table": NODE_TABLES[0] if out[0] else NODE_TABLES[1],
            "blocks_per_sm": out[1], "grid": out[2], "shared_bytes": out[3]}


def device_base_nodes(cb: ClusterBvh) -> torch.Tensor:
    """The kernel's packed base threading for `cb`, built once per device
    in the same cache as the sweep kernel's tables: (m, 2, 4) f32
    [min.xyz | skip], [max.xyz | cluster], the ints stored bit for bit
    in the float lanes."""
    key = (str(cb.device), "base_nodes")
    if key not in cb.device_tables:
        m = cb.n_nodes
        nodes = torch.zeros((m, 2, 4), dtype=torch.float32, device=cb.device)
        nodes[:, 0, :3] = cb.node_min[:m]
        nodes[:, 1, :3] = cb.node_max[:m]
        nodes.view(torch.int32)[:, 0, 3] = cb.node_skip[:m]
        nodes.view(torch.int32)[:, 1, 3] = cb.node_cluster[:m]
        cb.device_tables[key] = nodes.contiguous()
    return cb.device_tables[key]


@torch.no_grad()
def _launch(cb: ClusterBvh, origin, direction, anyhit: bool, t_max,
            force_global: bool):
    global LAUNCHES
    n = origin.shape[0]
    dev = origin.device
    t0 = _t_init(t_max, n, dev)
    out = {"hit_idx": torch.full((n,), -1, dtype=torch.int32, device=dev),
           "t": torch.empty((n,), dtype=torch.float32, device=dev),
           "visits": torch.zeros((n,), dtype=torch.int32, device=dev)}
    if n == 0:
        out["t"] = t0
        return out
    nodes = device_base_nodes(cb)
    _, tris = device_tables(cb)
    # the persistent schedule's batch counter, zero at the launch
    next_batch = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = load_kernel()
    entry = (lib.drt_traverse_pallas_global if force_global
             else lib.drt_traverse_pallas)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(origin.data_ptr(), direction.data_ptr(), t0.data_ptr(),
                    n, nodes.data_ptr(), cb.n_nodes, _max_steps(cb),
                    tris.data_ptr(), cb.k, 1 if anyhit else 0,
                    out["hit_idx"].data_ptr(), out["t"].data_ptr(),
                    next_batch.data_ptr(), stream)
    _raise_on(lib, err, "kernel launch")
    LAUNCHES += 1
    return out


def _traverse(cb: ClusterBvh, origin, direction, anyhit: bool, t_max,
              force_global: bool) -> dict:
    _check_rays(cb, origin, direction)
    if cb.k < 1:
        raise ValueError(f"clusters of K = {cb.k} triangles: the kernel "
                         "takes K >= 1")
    if origin.device.type == "cuda":
        return _launch(cb, origin, direction, anyhit, t_max, force_global)
    if origin.device.type == "cpu":
        return traverse_cluster_pallas_reference(cb, origin, direction,
                                                 anyhit=anyhit, t_max=t_max)
    raise ValueError(f"traverse_cluster_pallas: unsupported device "
                     f"{origin.device}")


def traverse_cluster_pallas(cb: ClusterBvh, origin, direction, *,
                            anyhit: bool = False, t_max=None) -> dict:
    """Closest-hit (or any-hit) traversal of the base threading.

    origin/direction: contiguous (N, 3) float32 on one device; t_max: a
    scalar or (N,) initial t per ray (default 3.4e38). A CUDA tensor
    launches the kernel (a failed build or launch raises); a CPU tensor
    runs the twin."""
    return _traverse(cb, origin, direction, anyhit, t_max, False)


def traverse_cluster_pallas_global(cb: ClusterBvh, origin, direction, *,
                                   anyhit: bool = False,
                                   t_max=None) -> dict:
    """traverse_cluster_pallas with the kernel's "global" instance (node
    reads through the read-only cache) whatever the table's size; a CPU
    tensor runs the twin."""
    return _traverse(cb, origin, direction, anyhit, t_max, True)
