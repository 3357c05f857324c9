"""Speed of light of the traversal kernel on an NVIDIA H100 (port of
utils/roofline.py, in Hopper terms).

Counting, which runs anywhere:

- `sweep_work` counts the work a wave's rays need from the sweep kernel's
  counting mode (ops/traverse_sweep.py, counters=True): one slab test per
  node a ray stood on, one K-wide Möller–Trumbore per leaf it tested,
  plus the bytes that must move (rays in, results out, each table read
  once). `bound_seconds` turns operations and bytes into the larger of
  the two times at the card's published peaks.

Measuring, on the card only: each of these raises without CUDA and never
times the CPU under a device name.

- `device_seconds_per_call` times back-to-back calls between CUDA
  events; `delta_time_dispatch` keeps the JAX module's host-clock
  deltas for any fence.
- `measure_peaks`: the card's measured ceilings (f32 and bf16 matmul,
  the FP32 rate outside the tensor cores by the hand kernel
  `csrc/peaks.cu`, HBM bytes/s), each held to at most 105% of NVIDIA's
  figure.
- `calibrate_sweep_rates`: K1's own cost per warp iteration, per
  iteration that serves leaves and per leaf served, from chain scenes
  that never diverge, read through its own work counters.
- `sweep_attribution`: a real wave's device time against its counted
  work at those rates (`sol_pct`); `price_sweep` is its arithmetic.

Replaying, in float64 numpy, anywhere: `volume_efficiency` and
`walk_stats` walk sampled warps of a wave ray by ray (`_sim_tile`) and
set the work the rays needed against the work the kernel's counters
say it executed (SIMT warp efficiency).

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

import math
import time

import numpy as np
import torch

FP32_FLOPS = 67e12    # H100 SXM, FP32 outside the tensor cores, 700 W
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
# NVIDIA's data sheet (H100 SXM, dense, 700 W) for measure_peaks' keys
PUBLISHED = {"mxu_f32_highest_tflops": 67.0, "mxu_bf16_tflops": 989.0,
             "vpu_f32_tflops": 67.0, "hbm_gbps": 3350.0}
PEAK_CEILING = 1.05  # a reading above 105% of the published figure raises
SLAB_OPS = 26
MT_OPS = 57
RAY_OPS = 3
WARP = 32
RAY_BYTES = 7 * 4  # origin, direction, t_max: f32 each
BIG = 3.4e38
SOL_CEILING_PCT = 170.0
MM_N = 2048                    # measure_peaks' matmul side
FMA_ITERS = (1024, 33792)      # measure_peaks' two FMA chain lengths
HBM_FLOATS = 96 * 1024 * 1024  # measure_peaks' 384 MB buffer
# calibration chains: rays (a persistent grid many times over), the
# chain lengths, one leaf every CHAIN_LEAF_EVERY nodes, and the lanes of
# each warp that enter a leaf of the sparse-leaf chain (about the real
# waves' 32 * useful_share)
CHAIN_RAYS = 262_144
CHAIN_M = (128, 512)
CHAIN_LEAF_EVERY = 4
CHAIN_LANES = 8
# the device holds still this many clock cycles (~10 ms) while the host
# queues the calls that device_seconds_per_call times
HOLD_CYCLES = 20_000_000
REPLAY_CHUNK = 8192  # rays per _sim_tile call (two (n, m) bool tables)


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


# --- timing on the card -------------------------------------------------

def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures the card, and "
                           "torch.cuda.is_available() is False")


def _card() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device())


def delta_time_dispatch(dispatch, fence, reps: int = 8,
                        rounds: int = 5) -> float:
    """Seconds per dispatch on the host clock: wall(2R reps) - wall(R
    reps), the MEDIAN of `rounds` deltas, after one warm-up; a fixed cost
    per fenced run cancels. `fence(out)` waits for the last dispatch's
    result; pass `torch.cuda.synchronize` to time the card (it raises
    without CUDA). Median, not min: a stall inside the R segment deflates
    that round's delta, and min would keep the most corrupted reading.

    A non-positive median is a measurement failure (noise >= workload):
    one retry with doubled reps, then RuntimeError, never a return. For
    a kernel's device time prefer `device_seconds_per_call`."""
    if fence is torch.cuda.synchronize:
        _require_cuda("delta_time_dispatch with torch.cuda.synchronize")

        def fence(_out):
            torch.cuda.synchronize()

    def run(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = dispatch()
        fence(out)
        return time.perf_counter() - t0

    run(2)  # warm the dispatch pipeline
    for _ in range(2):
        deltas = []
        for _ in range(rounds):
            t1 = run(reps)
            t2 = run(2 * reps)
            deltas.append((t2 - t1) / reps)
        med = float(np.median(deltas))
        if med > 0:
            return med
        reps *= 2  # more signal per segment drowns the jitter
    raise RuntimeError(
        f"non-positive delta timing (median {med*1e3:.2f} ms over "
        f"{rounds} rounds at reps={reps}): workload too small for "
        "cross-dispatch deltas; use device_seconds_per_call")


def _events_span(calls, n: int) -> float:
    """Device seconds from the first of n back-to-back calls(i) to the
    end of the last, between CUDA events. The device first sleeps while
    the host queues the calls, so none waits for the host; if the host
    was not done before the sleep ended, the sleep is lengthened and the
    span taken again."""
    hold = HOLD_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(hold)
        e0.record()
        for i in range(n):
            calls(i)
        e1.record()
        queued_in_time = not e0.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return e0.elapsed_time(e1) / 1e3
        hold *= 4
    raise RuntimeError(f"the host could not queue {n} calls within "
                       f"{hold // 4} device cycles")


def device_seconds_per_call(call, n_lo: int = 2, n_hi: int = 8,
                            repeats: int = 3, strict: bool = False) -> float:
    """Device seconds for ONE call of `call(i)`: the slope (t_hi - t_lo) /
    (n_hi - n_lo) between n_lo and n_hi back-to-back calls on the current
    stream, each span between CUDA events (best of `repeats`, after a
    warm-up and a synchronise). The calls are queued while the device
    holds still, so the span is device time, not host time; a constant
    cost per span (the events, the first launch) cancels in the slope.
    Every kernel a call launches counts, the wrapper's fills included.

    `i` is the repetition index. Eager PyTorch merges nothing, so the
    call may ignore it; the JAX module's callers perturb an input by it
    to defeat XLA's CSE. `strict=True` raises on a non-positive slope
    instead of returning it."""
    _require_cuda("device_seconds_per_call")
    call(0)  # warm-up: builds, caches, the allocator
    torch.cuda.synchronize()

    def best(n):
        return min(_events_span(call, n) for _ in range(repeats))

    slope = (best(n_hi) - best(n_lo)) / (n_hi - n_lo)
    if strict and slope <= 0:
        raise RuntimeError(
            f"non-positive slope ({slope*1e3:.4f} ms/call, n {n_lo}->"
            f"{n_hi}): the call is below the timing noise")
    return slope


def measure_peaks(repeats: int = 3) -> dict:
    """The ceilings of the attached card, each a delta rate between two
    iteration counts (extra work / extra device time, CUDA events, best
    of `repeats`), as the JAX module measures them:

    - `mxu_f32_highest_tflops`: chained 2048^3 float32 products by
      torch.matmul with TF32 off (`allow_tf32` is set False for the
      measurement and reported): cuBLAS's full-float32 rate;
    - `mxu_bf16_tflops`: the same chain in bf16: cuBLAS's rate at 2048,
      not the card's tensor-core peak;
    - `vpu_f32_tflops`: the FP32 rate outside the tensor cores, by the
      hand kernel csrc/peaks.cu (ops/peaks.py) on a grid that fills every
      SM, 2 FLOPs per fmaf;
    - `hbm_gbps`: in-place `v.add_(1.0)` on 96 Mi float32 (384 MB, past
      the 50 MB L2), 2 x the buffer's bytes per iteration.

    A reading above 105% of NVIDIA's figure (PUBLISHED) raises; so does a
    non-positive delta."""
    _require_cuda("measure_peaks")
    from dustraytracer_tpu_torch.ops import peaks as pk

    dev = _card()

    def span(fn, iters):
        fn(iters)  # warm-up
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(repeats):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn(iters)
            e1.record()
            torch.cuda.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3)
        return best

    def delta_rate(name, fn, work_per_iter, n1, n2):
        dt = span(fn, n2) - span(fn, n1)
        if dt <= 0:
            raise RuntimeError(f"measure_peaks {name}: non-positive delta "
                               f"{dt:.3e} s between {n1} and {n2} iterations")
        return (n2 - n1) * work_per_iter / dt

    n = MM_N
    out = {"device": torch.cuda.get_device_name(dev), "allow_tf32": False}

    def mm_chain(dtype):
        # a = b = 1/n: every product is 1/n again, exact in bf16 and f32
        a = torch.full((n, n), 1.0 / n, dtype=dtype, device=dev)
        b = torch.full((n, n), 1.0 / n, dtype=dtype, device=dev)
        bufs = (torch.empty_like(a), torch.empty_like(a))

        def run(iters):
            acc = a
            for i in range(iters):
                acc = torch.matmul(acc, b, out=bufs[i % 2])
            return acc
        return run

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["mxu_f32_highest_tflops"] = delta_rate(
            "mxu_f32", mm_chain(torch.float32), 2.0 * n ** 3, 8, 40) / 1e12
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    out["mxu_bf16_tflops"] = delta_rate(
        "mxu_bf16", mm_chain(torch.bfloat16), 2.0 * n ** 3, 8, 40) / 1e12

    threads = pk.fill_threads(dev)
    x0 = torch.linspace(1.0, 1.25, threads, device=dev)
    out["vpu_f32_tflops"] = delta_rate(
        "vpu_f32", lambda iters: pk.fma_chain(x0, iters),
        2.0 * pk.CHAINS * threads, *FMA_ITERS) / 1e12
    out["vpu_threads"] = threads

    big = torch.ones(HBM_FLOATS, dtype=torch.float32, device=dev)

    def add_chain(iters):
        for _ in range(iters):
            big.add_(1.0)

    out["hbm_gbps"] = delta_rate("hbm", add_chain, 2.0 * big.numel() * 4,
                                 2, 18) / 1e9
    del big
    for key, pub in PUBLISHED.items():
        if out[key] > PEAK_CEILING * pub:
            raise RuntimeError(
                f"measure_peaks {key} = {out[key]:.1f}, above "
                f"{PEAK_CEILING:.0%} of NVIDIA's {pub}: the timing is wrong")
    return out


# --- K1's calibrated speed of light -------------------------------------

def _chain_bvh(m: int, leaf, k: int, c_pad: int, lanes: int | None = None):
    """Synthetic chain scene for the calibration, on the CPU: m nodes, node
    i + 1 after node i in every one of the 8 octant threadings (the
    kernel walks a ray's own octant), all clusters empty (tri_idx -1), so
    no ray ever hits and every ray stands on all m nodes.

    leaf: False -> all interior, True -> all leaves, int p -> every p-th
    node a leaf (node i is a leaf when i % p == p - 1). Boxes span +-1e30,
    so every ray of `_chain_rays` enters every node but the last; with
    `lanes`, the leaf boxes end at x = lanes - 0.5, so a ray from x =
    lane moving to +x enters them only in the first `lanes` lanes of its
    warp, and the others skip on to node i + 1 like the rest. The last
    node ends every walk: its box lies behind the rays (x = -1e30), so no
    ray enters it, and its skip is -1 (the kernel's end of a walk; an
    entered interior node would send a ray to node m, and the JAX chain
    ends at skip == m instead)."""
    from dustraytracer_tpu_torch.accel.cluster import ClusterBvh

    big = 1e30
    node_min = np.full((m, 3), -big, np.float32)
    node_max = np.full((m, 3), big, np.float32)
    skip = np.arange(1, m + 1, dtype=np.int32)
    skip[-1] = -1
    if isinstance(leaf, bool):
        cluster = (np.zeros(m, np.int32) if leaf
                   else np.full(m, -1, np.int32))
    else:
        cluster = np.where(np.arange(m) % leaf == leaf - 1, 0, -1) \
            .astype(np.int32)
    if lanes is not None:
        node_max[cluster >= 0, 0] = lanes - 0.5
    node_min[-1, 0] = node_max[-1, 0] = -big
    z3 = torch.zeros((c_pad, k, 3))

    def t(a):
        return torch.from_numpy(a)

    def oct8(a):
        return t(np.ascontiguousarray(np.broadcast_to(a, (8,) + a.shape)))

    return ClusterBvh(
        node_min=t(node_min), node_max=t(node_max), node_skip=t(skip),
        node_cluster=t(cluster), v0=z3, e1=z3.clone(), e2=z3.clone(),
        tri_idx=torch.full((c_pad, k), -1, dtype=torch.int32),
        n_nodes=m, n_clusters=1, k=k,
        oct_min=oct8(node_min), oct_max=oct8(node_max), oct_skip=oct8(skip),
        oct_cluster=oct8(cluster),
        oct_perm0=oct8(np.arange(m, dtype=np.int32)))


def _chain_rays(n: int, seed: int = 0):
    """n rays for the chain scenes (float32, CPU): ray r starts at x =
    r % 32 (its lane), y and z uniform in [-1, 1], and moves to +x with a
    small y, z slope."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = np.arange(n) % WARP
    o[:, 1:] = rng.uniform(-1, 1, (n, 2))
    d = np.ones((n, 3), np.float32)
    d[:, 1:] = rng.uniform(-0.5, 0.5, (n, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def calibrate_sweep_rates(k: int, c_pad: int, reps: int = 3) -> dict:
    """K1's own costs on this card, from chain scenes that never diverge
    (every lane of a warp walks the same m nodes), timed by
    `device_seconds_per_call` on the plain instance (the main path's) and
    counted by the counting instance on the same rays. Its cost model:

        device time ~ W * window_ns + E * leaf_iter_ns + S * leaf_ns

    W = sum exec_windows (warp iterations), E = sum exec_leafs
    (iterations that served at least one leaf), S = sum leaf_tests
    (leaves served, one after another). Each rate is device time per
    unit over the whole grid: the card runs many warps at once, so
    `window_ns` is far below one iteration's latency. Three chains,
    m = 128 and 512 each, give the three:

    - interior: W grows, E = S = 0 -> `window_ns`;
    - dense-leaf: a leaf every CHAIN_LEAF_EVERY nodes, entered by all 32
      lanes: 32 leaves per leaf iteration;
    - sparse-leaf: the same leaves, entered by CHAIN_LANES lanes of 32;
      the two give `leaf_ns` (the cost of one more leaf served) and
      `leaf_iter_ns`, the line's intercept: what a leaf iteration costs
      beyond its leaves. The intercept may come out negative, when L
      leaves of one iteration cost less than L marginal leaves (the last
      leaf of an iteration prefetches no next row); the model then holds
      between the two chains' leaves per iteration, CHAIN_LANES and 32.

    The JAX module's `leaf_serial_ns` has no counterpart: this kernel
    always serves leaves one after another, at `leaf_ns`. `n_tiles` is
    the number of warps of the calibration wave; `leaf_iteration_ns` the
    measured cost of one leaf iteration of each leaf chain; `chains` each
    chain's seconds per call and W, E, S. A degenerate
    fit raises: no growth of time or counts between the chain lengths,
    window_ns or leaf_ns <= 0, or a leaf iteration that costs <= 0."""
    _require_cuda("calibrate_sweep_rates")
    from dustraytracer_tpu_torch.ops.traverse_sweep import \
        traverse_cluster_sweep

    dev = _card()
    o, d = (x.to(dev) for x in _chain_rays(CHAIN_RAYS))

    def run(m, leaf, lanes=None, n_hi=10):
        cb = _chain_bvh(m, leaf, k, c_pad, lanes).to(dev)
        t = device_seconds_per_call(
            lambda _i: traverse_cluster_sweep(cb, o, d), n_lo=2, n_hi=n_hi,
            repeats=reps)
        r = traverse_cluster_sweep(cb, o, d, counters=True)
        return {"m": m, "seconds": t,
                "exec_windows": int(r["exec_windows"].sum()),
                "exec_leafs": int(r["exec_leafs"].sum()),
                "leaf_tests": int(r["leaf_tests"].sum())}

    m1, m2 = CHAIN_M
    p, lanes = CHAIN_LEAF_EVERY, CHAIN_LANES
    chains = {"interior": [run(m, False) for m in CHAIN_M],
              "dense_leaf": [run(m, p, n_hi=8) for m in CHAIN_M],
              "sparse_leaf": [run(m, p, lanes, n_hi=8) for m in CHAIN_M]}

    def delta(name, key):
        a, b = chains[name]
        return b[key] - a[key]

    dt, dw = delta("interior", "seconds"), delta("interior", "exec_windows")
    if not (dt > 0 and dw > 0):
        raise RuntimeError(f"degenerate window calibration: {dt:.3e} s "
                           f"over {dw} windows (m {m1}->{m2})")
    window_ns = dt / dw * 1e9

    per_iter, per_serve = {}, {}
    for name in ("dense_leaf", "sparse_leaf"):
        dt, de = delta(name, "seconds"), delta(name, "exec_leafs")
        if not (dt > 0 and de > 0):
            raise RuntimeError(f"degenerate {name} calibration: {dt:.3e} s "
                               f"over {de} leaf iterations")
        leaf_dt = dt * 1e9 - delta(name, "exec_windows") * window_ns
        per_iter[name] = leaf_dt / de  # ns per leaf iteration
        per_serve[name] = delta(name, "leaf_tests") / de  # leaves in one
    spread = per_serve["dense_leaf"] - per_serve["sparse_leaf"]
    if spread <= 0:
        raise RuntimeError(f"degenerate leaf chains: {per_serve} leaves "
                           "per leaf iteration")
    leaf_ns = (per_iter["dense_leaf"] - per_iter["sparse_leaf"]) / spread
    leaf_iter_ns = per_iter["sparse_leaf"] - per_serve["sparse_leaf"] \
        * leaf_ns
    if leaf_ns <= 0 or min(per_iter.values()) <= 0:
        raise RuntimeError(f"degenerate leaf rates: leaf_ns {leaf_ns:.4g}, "
                           f"leaf_iter_ns {leaf_iter_ns:.4g} (ns per leaf "
                           f"iteration {per_iter})")
    return {"window_ns": window_ns, "leaf_ns": leaf_ns,
            "leaf_iter_ns": leaf_iter_ns, "n_tiles": -(-CHAIN_RAYS // WARP),
            "leaf_iteration_ns": per_iter, "chains": chains}


def price_sweep(counters: dict, rates: dict, measured_s: float,
                n_rays: int) -> dict:
    """Counted work priced at the calibrated rates against a measured
    time: `counters` holds W, E, S as "exec_windows", "exec_leafs",
    "leaf_tests" (sums over the wave). sol_raw_pct = model / measured;
    sol_pct is it clipped at 100 (the chains, which never diverge, price
    each unit at its best). A model above 170% of the measurement means
    the calibration does not describe this card's run: RuntimeError."""
    t_win = counters["exec_windows"] * rates["window_ns"] * 1e-9
    t_leaf = (counters["exec_leafs"] * rates["leaf_iter_ns"]
              + counters["leaf_tests"] * rates["leaf_ns"]) * 1e-9
    model = t_win + t_leaf
    ratio = 100.0 * model / measured_s
    if ratio > SOL_CEILING_PCT:
        raise RuntimeError(
            f"inconsistent SoL calibration: model {model*1e3:.4f} ms vs "
            f"measured {measured_s*1e3:.4f} ms ({ratio:.0f}%)")
    return {"model_s": model,
            "window_share_pct": 100.0 * t_win / measured_s,
            "leaf_share_pct": 100.0 * t_leaf / measured_s,
            "sol_pct": min(ratio, 100.0),
            "sol_raw_pct": ratio,
            "sol_mrays_per_s": n_rays / model / 1e6}


def sweep_attribution(cb, origin, direction, rates: dict | None = None,
                      reps: int = 3, anyhit: bool = False) -> dict:
    """K1 on a real wave (CUDA tensors): the device seconds per call of
    the plain instance (closest, or any-hit with `anyhit`), timed by
    `device_seconds_per_call`, and W, E, S from the counting instance on
    the same rays (its hit_idx, t and visits are the plain instance's).
    Returns measured_s, mrays_per_s, the counters, their means per warp
    (`n_tiles` = warps) and, with `rates`, `price_sweep`'s model_s,
    window_share_pct, leaf_share_pct, sol_pct, sol_raw_pct and
    sol_mrays_per_s."""
    _require_cuda("sweep_attribution")
    from dustraytracer_tpu_torch.ops.traverse_sweep import \
        traverse_cluster_sweep

    n = origin.shape[0]
    t = device_seconds_per_call(
        lambda _i: traverse_cluster_sweep(cb, origin, direction,
                                          anyhit=anyhit),
        n_lo=2, n_hi=8, repeats=reps, strict=True)
    r = traverse_cluster_sweep(cb, origin, direction, anyhit=anyhit,
                               counters=True)
    counters = {key: int(r[key].sum())
                for key in ("exec_windows", "exec_leafs", "leaf_tests")}
    warps = -(-n // WARP)
    out = {"measured_s": t, "mrays_per_s": n / t / 1e6, **counters,
           "n_tiles": warps,
           "windows_per_tile": counters["exec_windows"] / warps,
           "leafs_per_tile": counters["exec_leafs"] / warps,
           "leaf_tests_per_tile": counters["leaf_tests"] / warps}
    if rates is not None:
        out.update(price_sweep(counters, rates, t, n))
    return out


# --- the float64 replay -------------------------------------------------

def _sorted_rays(cluster, origin, direction):
    """Sort rays (numpy (N, 3) float32) as the integrator's
    _sorted_tracers does, by ray_sort_key over the cluster root's box."""
    from dustraytracer_tpu_torch.render.integrator import ray_sort_key

    lo = cluster.node_min[0].detach().cpu()
    hi = cluster.node_max[0].detach().cpu()
    key = ray_sort_key(lo, hi, torch.from_numpy(np.asarray(origin)),
                       torch.from_numpy(np.asarray(direction))).numpy()
    perm = np.argsort(key, kind="stable")
    return origin[perm], direction[perm]


def _sim_tile(tabs, o, d, anyhit: bool = False):
    """Numpy replay of the walk for rays o, d ((T, 3) float64), each ray on
    its own: (visited (T, m) bool, entered (T, m) bool, leaf_visits (T,)).

    visited = the ray stood on the node (a slab test, one lane slot of a
    warp iteration); entered = it passed the slab + t test there (an
    entered leaf is a leaf the kernel tests). With `anyhit`, a ray ends at
    the leaf where it first finds a hit, as the kernel's any-hit mode
    does; without, this is the JAX module's _sim_tile."""
    node_min, node_max, skip, ncl, v0, e1, e2, tri_idx, m = tabs
    n = o.shape[0]
    inv_d = 1.0 / d
    node = np.zeros(n, np.int64)
    hit_t = np.full(n, 3.4e38)
    visited = np.zeros((n, m), bool)
    entered_m = np.zeros((n, m), bool)
    leaf_visits = np.zeros(n, np.int64)

    while True:
        active = node < m
        if not active.any():
            break
        nd = np.where(active, node, 0)
        visited[active, nd[active]] = True

        bmin = node_min[nd]
        bmax = node_max[nd]
        t0 = (bmin - o) * inv_d
        t1 = (bmax - o) * inv_d
        tlo = np.fmin(t0, t1).max(axis=1)
        thi = np.fmax(t0, t1).min(axis=1)
        t_enter = np.maximum(tlo, 0.0)
        box_hit = (t_enter <= thi) & (thi >= 0.0)
        enter = active & box_hit & (t_enter < hit_t)
        entered_m[enter, nd[enter]] = True
        is_leaf = ncl[nd] >= 0

        # leaf: intersect the cluster's K triangles (for distance culling)
        lf = enter & is_leaf
        found = np.zeros(n, bool)
        if lf.any():
            leaf_visits[lf] += 1
            cl = ncl[nd[lf]]
            lv0, le1, le2 = v0[cl], e1[cl], e2[cl]  # (L, K, 3)
            ld = d[lf][:, None, :]
            lo_ = o[lf][:, None, :]
            p = np.cross(ld, le2)
            det = (le1 * p).sum(-1)
            par = np.abs(det) < 1e-6
            inv = 1.0 / np.where(par, 1.0, det)
            tv = lo_ - lv0
            u = inv * (tv * p).sum(-1)
            q = np.cross(tv, le1)
            v = inv * (ld * q).sum(-1)
            tt = inv * (le2 * q).sum(-1)
            ok = (~par) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) \
                & (tt > 1e-6) & (tri_idx[cl] >= 0)
            tt = np.where(ok, tt, 3.4e38)
            best = tt.min(axis=1)
            found[lf] = best < hit_t[lf]
            hit_t[lf] = np.minimum(hit_t[lf], best)

        nxt = np.where(enter & ~is_leaf, nd + 1, skip[nd])
        if anyhit:
            nxt = np.where(found, m, nxt)
        node = np.where(active, nxt, node)
    return visited, entered_m, leaf_visits


def _replay_tabs(cluster, oct_id: int | None = None):
    """Node and cluster tables for the numpy replay (float64 boxes and
    triangles; skip -1 becomes m, the replay's end). With `oct_id` and a
    cluster carrying octant threadings, that threading's node tables: the
    replay must walk what the kernel walks."""
    def a(x, dtype=None):
        return np.asarray(x.detach().cpu().numpy(), dtype)

    m = cluster.n_nodes
    if oct_id is not None and cluster.oct_min is not None:
        node_min = a(cluster.oct_min[oct_id], np.float64)
        node_max = a(cluster.oct_max[oct_id], np.float64)
        skip = a(cluster.oct_skip[oct_id])
        ncl = a(cluster.oct_cluster[oct_id])
    else:
        node_min = a(cluster.node_min, np.float64)
        node_max = a(cluster.node_max, np.float64)
        skip = a(cluster.node_skip)
        ncl = a(cluster.node_cluster)
    skip = np.where(skip < 0, m, skip)
    return (node_min, node_max, skip, ncl,
            a(cluster.v0, np.float64), a(cluster.e1, np.float64),
            a(cluster.e2, np.float64), a(cluster.tri_idx), m)


def _ray_octant(d: np.ndarray) -> np.ndarray:
    """Each ray's direction octant, bit2 = x<0, bit1 = y<0, bit0 = z<0: the
    threading the kernel walks for it (the TPU kernel takes a tile's first
    ray for the whole tile)."""
    return (d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2 + (d[:, 2] < 0).astype(int)


def _sample_warps(n: int, max_tiles: int) -> np.ndarray:
    """`max_tiles` of the wave's warps, drawn uniformly without
    replacement (seed 0), in order; every warp when that many cover the
    wave. Not an even stride, as in the JAX module: in a 512-wide camera
    wave sorted by octant, warp w holds columns 32 (w % 16) onward of its
    image row, so a stride of 4 or 8 warps samples the same columns in
    every row (walk share 80.5% against the whole wave's 77.6%, by the
    twin's counts)."""
    n_warps = max(-(-n // WARP), 1)
    if max_tiles >= n_warps:
        return np.arange(n_warps)
    rng = np.random.default_rng(0)
    return np.sort(rng.choice(n_warps, max_tiles, replace=False))


def _replay_warps(cluster, o_all, d_all, warps, anyhit: bool) -> dict:
    """Replay the warps `warps` of the sorted wave (o_all, d_all: numpy
    float32), each ray in its own octant's threading. Per sampled ray (in
    warp order): "ray" (its index in the wave), "visits", "leaf_visits";
    per warp: "steps" (iterations of the warp's loop: its longest lane
    walk) and "leaf_steps" (iterations in which some lane entered a
    leaf). Lane s's s-th node falls in the warp's iteration s, because
    every live lane takes one step per iteration."""
    n = o_all.shape[0]
    ray = (warps[:, None] * WARP + np.arange(WARP)).reshape(-1)
    ray = ray[ray < n]
    o = o_all[ray].astype(np.float64)
    d = d_all[ray].astype(np.float64)
    warp_of = np.repeat(np.arange(len(warps)), WARP)[:len(ray)]
    visits = np.zeros(len(ray), np.int64)
    leaf_visits = np.zeros(len(ray), np.int64)
    leaf_keys = []  # warp * (m + 1) + iteration, per leaf entry
    octs = _ray_octant(d) if cluster.oct_min is not None \
        else np.full(len(ray), -1)
    m = cluster.n_nodes
    for oc in np.unique(octs):
        tabs = _replay_tabs(cluster, None if oc < 0 else int(oc))
        is_leaf = tabs[3][:m] >= 0
        sel = np.nonzero(octs == oc)[0]
        for part in np.array_split(sel, -(-len(sel) // REPLAY_CHUNK)):
            visited, entered, lv = _sim_tile(tabs, o[part], d[part], anyhit)
            visits[part] = visited.sum(axis=1)
            leaf_visits[part] = lv
            step = np.cumsum(visited, axis=1) - 1
            r, j = np.nonzero(entered & is_leaf)
            leaf_keys.append(warp_of[part[r]] * (m + 1) + step[r, j])
    keys = np.unique(np.concatenate(leaf_keys)) if leaf_keys else \
        np.zeros(0, np.int64)
    steps = np.zeros(len(warps), np.int64)
    np.maximum.at(steps, warp_of, visits)
    return {"ray": ray, "visits": visits, "leaf_visits": leaf_visits,
            "steps": steps,
            "leaf_steps": np.bincount(keys // (m + 1),
                                      minlength=len(warps))}


def volume_efficiency(cluster, origin, direction, rates: dict | None = None,
                      max_tiles: int = 32, anyhit: bool = False) -> dict:
    """Useful against EXECUTED traversal work, the SIMT warp efficiency of
    K1 (the JAX module's "GPU analog"). A tile here is a warp of 32
    consecutive sorted rays; `max_tiles` of them (`_sample_warps`) are
    replayed.

    The rays are sorted as the integrator sorts them and traced by K1's
    counting instance on the cluster's device (its twin on the CPU). The
    exact float64 replay (`_sim_tile`, each ray in its own octant's
    threading) gives the work the rays need; the kernel's counters give
    what the warps executed on the same warps:

    - vol_eff_window_pct = replayed sum of visits / (32 * sum
      exec_windows): lane slots of the warp loop that walked;
    - vol_eff_leaf_pct = replayed leaf entries / (32 * sum exec_leafs):
      lane slots of the leaf iterations whose lane had entered a leaf;
    - with `rates`, vol_eff_pct = useful / executed time at the
      calibrated rates, useful as if every lane slot were filled: visits /
      32 warp iterations, leaf entries / 32 leaf iterations and every
      leaf served (W * window_ns + E * leaf_iter_ns + S * leaf_ns). A
      negative leaf_iter_ns is priced at 0 on both sides: the chains then
      show no saving from serving more leaves in one iteration.

    These are sweep_work's walk_useful_share and useful_share on the
    sampled warps, from an independent walk: `visits_equal_pct` is the
    share of sampled rays whose replayed visits equal the kernel's, and
    `kernel_window_pct` the counters' own share on the same warps."""
    from dustraytracer_tpu_torch.ops.traverse_sweep import \
        traverse_cluster_sweep

    o_all = np.asarray(torch.as_tensor(origin).detach().cpu(), np.float32)
    d_all = np.asarray(torch.as_tensor(direction).detach().cpu(),
                       np.float32)
    o_all, d_all = _sorted_rays(cluster, o_all, d_all)
    dev = cluster.device
    r = traverse_cluster_sweep(
        cluster, torch.from_numpy(np.ascontiguousarray(o_all)).to(dev),
        torch.from_numpy(np.ascontiguousarray(d_all)).to(dev),
        anyhit=anyhit, counters=True)
    w_tile = r["exec_windows"].cpu().numpy().astype(np.int64)
    l_tile = r["exec_leafs"].cpu().numpy().astype(np.int64)
    k_visits = r["visits"].cpu().numpy()
    k_leaf = r["leaf_tests"].cpu().numpy()
    warps = _sample_warps(o_all.shape[0], max_tiles)
    # useful and executed work over the same warps, or neither: counters
    # shorter than the sample would inflate the shares
    if w_tile.shape[0] <= warps.max():
        raise RuntimeError(f"kernel counters cover {w_tile.shape[0]} warps "
                           f"but the replay samples warp {warps.max()}")
    rep = _replay_warps(cluster, o_all, d_all, warps, anyhit)
    useful_nodes = int(rep["visits"].sum())
    useful_leafs = int(rep["leaf_visits"].sum())
    exec_w = int(w_tile[warps].sum())
    exec_l = int(l_tile[warps].sum())
    out = {
        "n_tiles_sampled": len(warps),
        "n_rays_sampled": len(rep["ray"]),
        "useful_node_steps": useful_nodes,
        "useful_leaf_steps": useful_leafs,
        "exec_windows": exec_w,
        "exec_leafs": exec_l,
        "exec_node_slots": WARP * exec_w,
        "exec_leaf_slots": WARP * exec_l,
        "vol_eff_window_pct": 100.0 * useful_nodes / max(WARP * exec_w, 1),
        "vol_eff_leaf_pct": 100.0 * useful_leafs / max(WARP * exec_l, 1),
        "kernel_window_pct": 100.0 * float(k_visits[rep["ray"]].sum())
        / max(WARP * exec_w, 1),
        "visits_equal_pct": 100.0 * float(
            (rep["visits"] == k_visits[rep["ray"]]).mean()),
        "steps_equal_pct": 100.0 * float(
            (rep["steps"] == w_tile[warps]).mean()),
    }
    if rates is not None:
        def cost(windows, leaf_iters, served):
            return (windows * rates["window_ns"]
                    + leaf_iters * max(rates["leaf_iter_ns"], 0.0)
                    + served * rates["leaf_ns"])

        useful_t = cost(useful_nodes / WARP, useful_leafs / WARP,
                        useful_leafs)
        exec_t = cost(exec_w, exec_l, int(k_leaf[rep["ray"]].sum()))
        out["vol_eff_pct"] = 100.0 * useful_t / max(exec_t, 1e-12)
    return out


def walk_stats(cluster, origin, direction, max_tiles: int = 64,
               anyhit: bool = False) -> dict:
    """Exact numpy replay of K1's walk over `max_tiles` warps (tiles) of 32
    consecutive sorted rays (`_sample_warps`), each ray in its own
    octant's threading; no kernel runs. Returns the sampled warp ids
    ("tiles"), per warp the executed steps ("tile_steps": the longest lane
    walk, which is what the kernel's exec_windows must equal) and leaf
    iterations ("tile_leaf_steps": steps in which some lane entered a
    leaf, what exec_leafs must equal), and the mean visits and leaf visits
    per ray.

    The JAX module's tile steps are the union of the nodes a tile's rays
    visit, because its tile shares one cursor that stops at each of them.
    A warp here shares no cursor: each lane walks its own node, and the
    warp loops until its longest walk ends, so its steps are that
    walk's length."""
    o_all = np.asarray(torch.as_tensor(origin).detach().cpu(), np.float32)
    d_all = np.asarray(torch.as_tensor(direction).detach().cpu(),
                       np.float32)
    o_all, d_all = _sorted_rays(cluster, o_all, d_all)
    warps = _sample_warps(o_all.shape[0], max_tiles)
    rep = _replay_warps(cluster, o_all, d_all, warps, anyhit)
    n_sim = len(rep["ray"])
    return {
        "n_rays": n_sim,
        "tiles": warps,
        "tile_steps": rep["steps"],
        "tile_leaf_steps": rep["leaf_steps"],
        "mean_visits_per_ray": float(rep["visits"].sum()) / max(n_sim, 1),
        "mean_leaf_visits_per_ray":
        float(rep["leaf_visits"].sum()) / max(n_sim, 1),
    }
