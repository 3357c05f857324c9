"""Share of the material fetch's lanes that hold a live hit, in the
profiled steps: 100 drt.k4.live_lanes / drt.k4.lanes, the program's
counters (dustraytracer_tpu_torch/utils/profiling.py) that the stage
_shade adds at each material fetch while spans are on. K4, the fetch's
backward, is sized by all lanes; only the live ones carry a cotangent.
None where the program has no counters; a cell that lists this metric
and lacks a counter fails: a renamed counter must not read as 0."""

LIVE, LANES = "drt.k4.live_lanes", "drt.k4.lanes"


def read(record):
    if record["loop"] != "train":
        return None
    try:
        from dustraytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "count_device"):
        return None
    got = profiling.counters("drt.k4.")
    if LIVE not in got or not got.get(LANES):
        raise RuntimeError(f"k4_live_lane_pct.train: no counter {LIVE} or "
                           f"{LANES} in the program's counters")
    return 100.0 * got[LIVE] / got[LANES]
