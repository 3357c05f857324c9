"""Cluster-BVH traversal: the CUDA kernel and its plain PyTorch twin
(port of ops/traverse_sweep.py).

`traverse_cluster_sweep` launches `csrc/traverse_sweep.cu` on CUDA
tensors and runs `traverse_cluster_sweep_reference` on CPU tensors; any
other device raises. Both follow the same per-ray contract: walk the
pre-order threading of the ray's own direction octant, closest hit
(smallest t, ties to the lowest triangle id, strict improvement only) or
any hit, with a per-ray initial t (`t_max`). They return detached
{"hit_idx" i32 (-1 = miss), "t" f32, "visits" i32} tensors: traversal is
a discrete selector with no gradient. With `emit_attrs=True` (the
in-kernel shading fetch, settings.shade_fetch="kernel") they also return
the winning hit's barycentric "u", "v" (N,), interpolated "uv" (N, 2),
oriented "face_nrm" (N, 3) and material "mat" (N,) i32, read once per
ray from the cluster attribute tables; misses get zeros.

With `counters=True` (a third kernel instance; exclusive with
emit_attrs) they also return the executed work: "exec_windows" and
"exec_leafs" (ceil(N/32),) i32 and "leaf_tests" (N,) i32. The TPU
kernel counts per ray tile; the lockstep unit on the card is a warp of
32 consecutive rays, so here exec_windows[w] is the loop iterations warp
w executed (max visits over its lanes), exec_leafs[w] the iterations in
which at least one of its lanes entered a leaf (the warp then tests the
leaves of those lanes one after another, one triangle slot a lane), and
leaf_tests[r] the leaves ray r tested. utils/roofline.py prices them.

The kernel takes clusters of 1 to MAX_K triangles; both paths raise on
another K, so the CPU and the card accept the same tables.
"""

from __future__ import annotations

import ctypes

import torch

from dustraytracer_tpu_torch.accel.cluster import ClusterBvh

BIG = 3.4e38
_NO_ID = 2 ** 30

# kernel launches since import (or since a caller reset them), closest
# or any-hit without emission, with emit_attrs, and with counters; the
# twin never counts
LAUNCHES = 0
EMIT_LAUNCHES = 0
COUNT_LAUNCHES = 0
WARP = 32  # the lockstep unit of the counters
# a served leaf takes ceil(K / 32) triangle slots a lane; scene builds
# pick K = 8 to 64
MAX_K = 256
MODES = ("plain", "emit_attrs", "counters")  # the kernel's instances


def _octant(d: torch.Tensor) -> torch.Tensor:
    """bit2 = x<0, bit1 = y<0, bit0 = z<0 (ray_sort_key's leading bits)."""
    return ((d[:, 0] < 0).to(torch.int64) * 4
            + (d[:, 1] < 0).to(torch.int64) * 2
            + (d[:, 2] < 0).to(torch.int64))


def _oct_tables(cb: ClusterBvh):
    if cb.oct_min is None:
        raise ValueError("ClusterBvh has no octant threadings (oct_*)")
    m = cb.n_nodes
    return (cb.oct_min[:, :m].reshape(-1, 3), cb.oct_max[:, :m].reshape(-1, 3),
            cb.oct_skip[:, :m].reshape(-1).to(torch.int64),
            cb.oct_cluster[:, :m].reshape(-1).to(torch.int64))


def _check_rays(cb: ClusterBvh, origin, direction):
    for name, x in (("origin", origin), ("direction", direction)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (N, 3), got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if origin.shape != direction.shape:
        raise ValueError("origin and direction shapes differ: "
                         f"{tuple(origin.shape)} vs {tuple(direction.shape)}")
    if origin.device != direction.device:
        raise ValueError("origin and direction are on different devices")
    if cb.device != origin.device:
        raise ValueError(f"scene tables on {cb.device}, rays on "
                         f"{origin.device}")


def _t_init(t_max, n: int, device) -> torch.Tensor:
    if t_max is None:
        return torch.full((n,), BIG, dtype=torch.float32, device=device)
    t = torch.as_tensor(t_max, dtype=torch.float32, device=device)
    if t.dim() > 1 or (t.dim() == 1 and t.shape[0] != n):
        raise ValueError(f"t_max must be a scalar or (N,), got "
                         f"{tuple(t.shape)}")
    return torch.broadcast_to(t, (n,)).contiguous()


def _check_attrs(cb: ClusterBvh, emit_attrs: bool, counters: bool = False):
    if not 1 <= cb.k <= MAX_K:
        raise ValueError(f"clusters of K = {cb.k} triangles: the sweep "
                         f"kernel takes 1 <= K <= {MAX_K}")
    if emit_attrs and counters:
        raise ValueError("emit_attrs and counters are separate kernel "
                         "modes; ask for one")
    if emit_attrs and cb.uv is None:
        raise ValueError("emit_attrs requires attribute tables "
                         "(build_cluster_bvh uv/face_nrm/mat)")


def slab_enter(lo, hi, o, inv, cur_t):
    """The CUDA kernels' slab test of L rays (o, inv: (L, 3)) against
    their boxes (lo, hi: (L, 3)), in their operation order: whether each
    ray enters its box before its current hit t (L,). fmin/fmax drop a
    NaN operand, maximum/minimum keep it, as in the kernels."""
    tx0 = (lo[:, 0] - o[:, 0]) * inv[:, 0]
    tx1 = (hi[:, 0] - o[:, 0]) * inv[:, 0]
    ty0 = (lo[:, 1] - o[:, 1]) * inv[:, 1]
    ty1 = (hi[:, 1] - o[:, 1]) * inv[:, 1]
    tz0 = (lo[:, 2] - o[:, 2]) * inv[:, 2]
    tz1 = (hi[:, 2] - o[:, 2]) * inv[:, 2]
    t_lo = torch.maximum(torch.maximum(torch.fmin(tx0, tx1),
                                       torch.fmin(ty0, ty1)),
                         torch.fmin(tz0, tz1))
    t_hi = torch.minimum(torch.minimum(torch.fmax(tx0, tx1),
                                       torch.fmax(ty0, ty1)),
                         torch.fmax(tz0, tz1))
    t_enter = torch.clamp_min(t_lo, 0.0)
    return (t_enter <= t_hi) & (t_hi >= 0.0) & (t_enter < cur_t)


def cluster_mt(cb: ClusterBvh, cl, o, d):
    """Möller–Trumbore of L rays (o, d: (L, 3)) against the K triangles
    of their clusters `cl` (L,), in the CUDA kernels' operation order, one
    rounding each -> (parallel, u, v, t), each (L, K)."""
    v0, e1, e2 = cb.v0[cl], cb.e1[cl], cb.e2[cl]  # (L, K, 3)
    rx, ry, rz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    sx, sy, sz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    px = ry * e2z - rz * e2y
    py = rz * e2x - rx * e2z
    pz = rx * e2y - ry * e2x
    det = e1x * px + e1y * py + e1z * pz
    par = det.abs() < 1e-6
    inv_det = 1.0 / torch.where(par, torch.ones_like(det), det)
    tvx = sx - v0[..., 0]
    tvy = sy - v0[..., 1]
    tvz = sz - v0[..., 2]
    u = inv_det * (tvx * px + tvy * py + tvz * pz)
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = inv_det * (rx * qx + ry * qy + rz * qz)
    tt = inv_det * (e2x * qx + e2y * qy + e2z * qz)
    return par, u, v, tt


@torch.no_grad()
def traverse_cluster_sweep_reference(cb: ClusterBvh, origin, direction, *,
                                     anyhit: bool = False, t_max=None,
                                     emit_attrs: bool = False,
                                     counters: bool = False):
    """Plain PyTorch twin of the CUDA kernel: a lockstep per-lane walk.

    Every lane holds its own node pointer into its octant's threading;
    each step gathers the node rows of the live lanes, slab-tests them,
    and runs a K-wide Möller–Trumbore on the (n_leaf, K) cluster rows of
    the lanes that entered a leaf. Operations are in the kernel's order,
    one rounding each, so on the card the two agree bit for bit. With
    emit_attrs, a commit also records the winning slot and its u, v, and
    the attributes are read once per ray after the walk. With counters,
    iteration s of the loop is step s of every live lane, as it is
    iteration s of each warp's loop in the kernel."""
    _check_rays(cb, origin, direction)
    _check_attrs(cb, emit_attrs, counters)
    n = origin.shape[0]
    dev = origin.device
    box_lo, box_hi, skip_t, clus_t = _oct_tables(cb)
    m = cb.n_nodes
    k = cb.k

    hit_t = _t_init(t_max, n, dev).clone()
    hit_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    if counters:
        n_warps = -(-n // WARP)
        exec_leafs = torch.zeros((n_warps,), dtype=torch.int32, device=dev)
        leaf_tests = torch.zeros((n,), dtype=torch.int32, device=dev)
    if emit_attrs:  # winner's cluster (-1 = none), slot, u, v
        win_c = torch.full((n,), -1, dtype=torch.int64, device=dev)
        win_j = torch.zeros((n,), dtype=torch.int64, device=dev)
        win_u = torch.zeros((n,), dtype=torch.float32, device=dev)
        win_v = torch.zeros((n,), dtype=torch.float32, device=dev)

    lanes = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    base = _octant(direction) * m
    inv_dir = 1.0 / direction

    for _ in range(m + 4):  # pointers only move forward: <= m steps
        if not lanes.numel():
            break
        row = base[lanes] + node
        lo, hi = box_lo[row], box_hi[row]
        skip, cluster = skip_t[row], clus_t[row]
        visits[lanes] += 1
        cur_t = hit_t[lanes]
        enter = slab_enter(lo, hi, origin[lanes], inv_dir[lanes], cur_t)
        is_leaf = cluster >= 0
        nxt = torch.where(enter & ~is_leaf, node + 1, skip)

        at_leaf = torch.nonzero(enter & is_leaf).squeeze(1)
        if at_leaf.numel():
            ll = lanes[at_leaf]
            if counters:
                leaf_tests[ll] += 1
                exec_leafs[torch.unique(ll // WARP)] += 1
            cl = cluster[at_leaf]
            tri_id = cb.tri_idx[cl]                        # (L, K)
            par, u, v, tt = cluster_mt(cb, cl, origin[ll], direction[ll])
            leaf_t = cur_t[at_leaf][:, None]
            valid = (~par) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) \
                & (u + v <= 1.0) & (tt > 1e-6) & (tri_id >= 0) & (tt < leaf_t)
            t_masked = torch.where(valid, tt, BIG)
            best_t = t_masked.amin(dim=1)
            is_best = valid & (t_masked <= best_t[:, None])
            best_id = torch.where(is_best, tri_id, _NO_ID).amin(dim=1)
            improve = (best_t < leaf_t[:, 0]) & (best_id < _NO_ID)
            won = at_leaf[improve]
            hit_t[lanes[won]] = best_t[improve]
            hit_idx[lanes[won]] = best_id[improve]
            if emit_attrs:
                # the one slot holding (best_t, best_id): ids are unique
                sel = is_best & (tri_id == best_id[:, None])
                slot = sel.to(torch.int32).argmax(dim=1, keepdim=True)
                win_c[lanes[won]] = cl[improve]
                win_j[lanes[won]] = slot[improve, 0]
                win_u[lanes[won]] = u.gather(1, slot)[improve, 0]
                win_v[lanes[won]] = v.gather(1, slot)[improve, 0]
            if anyhit:
                nxt[won] = -1

        node = nxt
        live = nxt >= 0
        lanes, node = lanes[live], node[live]

    out = {"hit_idx": hit_idx, "t": hit_t, "visits": visits}
    if counters:
        pad = torch.zeros((n_warps * WARP - n,), dtype=torch.int32,
                          device=dev)
        out.update({
            "exec_windows": torch.cat([visits, pad]).view(-1, WARP)
            .amax(dim=1),
            "exec_leafs": exec_leafs, "leaf_tests": leaf_tests})
    if emit_attrs:
        hit = (win_c >= 0)[:, None]
        c_safe = torch.clamp_min(win_c, 0)
        uvs = cb.uv[c_safe, win_j]  # (N, 3, 2)
        w = 1.0 - win_u - win_v
        uv = (w[:, None] * uvs[:, 0] + win_u[:, None] * uvs[:, 1]
              + win_v[:, None] * uvs[:, 2])
        out.update({
            "u": win_u, "v": win_v,
            "uv": torch.where(hit, uv, 0.0),
            "face_nrm": torch.where(hit, cb.face_nrm[c_safe, win_j], 0.0),
            "mat": torch.where(hit[:, 0], cb.mat[c_safe, win_j], 0)
            .to(torch.int32)})
    return out


def load_kernel():
    """Load the kernel library, declaring every entry's C signature."""
    from dustraytracer_tpu_torch.ops.cuda_build import load_library

    rec = load_library("traverse_sweep")
    lib = rec["lib"]
    if not getattr(lib, "_drt_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.drt_traverse_sweep.argtypes = [p, p, p, i, p, i, p, i, i,
                                           p, p, p, p, p, p, p, p, p,
                                           p, p, p, p, p]
        lib.drt_traverse_sweep.restype = ctypes.c_int
        lib.drt_traverse_sweep_occupancy.argtypes = [
            i, ctypes.POINTER(ctypes.c_int)]
        lib.drt_traverse_sweep_occupancy.restype = ctypes.c_int
        lib.drt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.drt_cuda_error_string.restype = ctypes.c_char_p
        lib._drt_bound = True
    return lib


def occupancy() -> dict:
    """Resident blocks per SM of each kernel instance on the current card
    (the CUDA occupancy calculator's figure; the persistent launch runs
    that many blocks on every SM)."""
    lib = load_kernel()
    out = {}
    for mode, name in enumerate(MODES):
        blocks = ctypes.c_int(0)
        err = lib.drt_traverse_sweep_occupancy(mode, ctypes.byref(blocks))
        if err != 0:
            msg = lib.drt_cuda_error_string(err).decode()
            raise RuntimeError(f"traverse_sweep occupancy query failed: "
                               f"{msg} (cudaError {err})")
        out[name] = blocks.value
    return out


def device_tables(cb: ClusterBvh):
    """The kernel's packed tables for `cb`, built once per device:
    nodes (8, m, 2, 4) f32 [min.xyz | skip], [max.xyz | cluster] and
    triangles (C, K, 3, 4) f32 [v0.xyz | id], [e1.xyz | 0], [e2.xyz | 0],
    the ints stored bit for bit in the float lanes."""
    key = str(cb.device)
    if key not in cb.device_tables:
        if cb.oct_min is None:
            raise ValueError("ClusterBvh has no octant threadings (oct_*)")
        m = cb.n_nodes
        nodes = torch.zeros((8, m, 2, 4), dtype=torch.float32,
                            device=cb.device)
        nodes[:, :, 0, :3] = cb.oct_min[:, :m]
        nodes[:, :, 1, :3] = cb.oct_max[:, :m]
        nodes.view(torch.int32)[:, :, 0, 3] = cb.oct_skip[:, :m]
        nodes.view(torch.int32)[:, :, 1, 3] = cb.oct_cluster[:, :m]
        c, k = cb.v0.shape[0], cb.v0.shape[1]
        tris = torch.zeros((c, k, 3, 4), dtype=torch.float32,
                           device=cb.device)
        tris[:, :, 0, :3] = cb.v0
        tris[:, :, 1, :3] = cb.e1
        tris[:, :, 2, :3] = cb.e2
        tris.view(torch.int32)[:, :, 0, 3] = cb.tri_idx
        cb.device_tables[key] = (nodes.contiguous(), tris.contiguous())
    return cb.device_tables[key]


def device_attr_table(cb: ClusterBvh):
    """The emit mode's packed attribute table for `cb`, built once per
    device on first use: per triangle slot (C, K, 3, 4) f32
    [uv0.xy uv1.xy], [uv2.xy fn.xy], [fn.z mat 0 0], mat stored bit for
    bit in its float lane."""
    key = (str(cb.device), "attrs")
    if key not in cb.device_tables:
        _check_attrs(cb, True)
        c, k = cb.uv.shape[0], cb.uv.shape[1]
        attrs = torch.zeros((c, k, 3, 4), dtype=torch.float32,
                            device=cb.device)
        attrs[:, :, 0, :] = cb.uv[:, :, 0:2].reshape(c, k, 4)
        attrs[:, :, 1, 0:2] = cb.uv[:, :, 2]
        attrs[:, :, 1, 2:4] = cb.face_nrm[..., 0:2]
        attrs[:, :, 2, 0] = cb.face_nrm[..., 2]
        attrs.view(torch.int32)[:, :, 2, 1] = cb.mat
        cb.device_tables[key] = attrs.contiguous()
    return cb.device_tables[key]


@torch.no_grad()
def _launch(cb: ClusterBvh, origin, direction, anyhit: bool, t_max,
            emit_attrs: bool, counters: bool):
    global LAUNCHES, EMIT_LAUNCHES, COUNT_LAUNCHES
    n = origin.shape[0]
    dev = origin.device
    t0 = _t_init(t_max, n, dev)
    out = {"hit_idx": torch.full((n,), -1, dtype=torch.int32, device=dev),
           "t": torch.empty((n,), dtype=torch.float32, device=dev),
           "visits": torch.zeros((n,), dtype=torch.int32, device=dev)}
    if emit_attrs:
        out.update({
            "u": torch.empty((n,), dtype=torch.float32, device=dev),
            "v": torch.empty((n,), dtype=torch.float32, device=dev),
            "uv": torch.empty((n, 2), dtype=torch.float32, device=dev),
            "face_nrm": torch.empty((n, 3), dtype=torch.float32, device=dev),
            "mat": torch.empty((n,), dtype=torch.int32, device=dev)})
    if counters:
        n_warps = -(-n // WARP)
        out.update({
            "exec_windows": torch.zeros((n_warps,), dtype=torch.int32,
                                        device=dev),
            "exec_leafs": torch.zeros((n_warps,), dtype=torch.int32,
                                      device=dev),
            "leaf_tests": torch.zeros((n,), dtype=torch.int32, device=dev)})
    if n == 0:
        out["t"] = t0
        return out
    nodes, tris = device_tables(cb)
    attrs = device_attr_table(cb) if emit_attrs else None

    def ptr(key):  # NULL for the outputs of a mode that is off
        return out[key].data_ptr() if key in out else None

    # the persistent schedule's batch counter, zero at the launch
    next_batch = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.drt_traverse_sweep(
            origin.data_ptr(), direction.data_ptr(), t0.data_ptr(), n,
            nodes.data_ptr(), cb.n_nodes, tris.data_ptr(), cb.k,
            1 if anyhit else 0, ptr("hit_idx"), ptr("t"), ptr("visits"),
            None if attrs is None else attrs.data_ptr(), ptr("u"), ptr("v"),
            ptr("uv"), ptr("face_nrm"), ptr("mat"), ptr("exec_windows"),
            ptr("exec_leafs"), ptr("leaf_tests"), next_batch.data_ptr(),
            stream)
    if err != 0:
        msg = lib.drt_cuda_error_string(err).decode()
        raise RuntimeError(f"traverse_sweep kernel launch failed: {msg} "
                           f"(cudaError {err})")
    if emit_attrs:
        EMIT_LAUNCHES += 1
    elif counters:
        COUNT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def traverse_cluster_sweep(cb: ClusterBvh, origin, direction, *,
                           anyhit: bool = False, t_max=None,
                           emit_attrs: bool = False,
                           counters: bool = False) -> dict:
    """Closest-hit (or any-hit) traversal of the cluster BVH.

    origin/direction: contiguous (N, 3) float32 on one device; t_max: a
    scalar or (N,) initial t per ray (default 3.4e38); emit_attrs: also
    return the winner's u, v, uv, face_nrm, mat (needs cb.uv); counters:
    also return exec_windows, exec_leafs (per warp of 32 rays) and
    leaf_tests (per ray). A CUDA tensor launches the kernel (a failed
    build or launch raises); a CPU tensor runs the twin."""
    _check_rays(cb, origin, direction)
    _check_attrs(cb, emit_attrs, counters)
    if origin.device.type == "cuda":
        return _launch(cb, origin, direction, anyhit, t_max, emit_attrs,
                       counters)
    if origin.device.type == "cpu":
        return traverse_cluster_sweep_reference(cb, origin, direction,
                                                anyhit=anyhit, t_max=t_max,
                                                emit_attrs=emit_attrs,
                                                counters=counters)
    raise ValueError(f"traverse_cluster_sweep: unsupported device "
                     f"{origin.device}")
