"""Load skew between the cards of a tiles frame: 100 (slowest - fastest)
/ slowest of the cards' device ms, each card's the sum over the profiled
frames of its drt.tile.c{i}.device_ms timer. The program
(render/film.py, render/graphed.py) records that timer's CUDA events on
card i's stream around each replayed stage (its input load and one graph
launch) and around the film add, so the time a card waits for the host's
next launch is not in it: it is the card's work, not the host's issue
order. The row bands hold different work: the sky's rows trace little,
the sphere's and the ground's the most. None outside the tiles loop or
where the program has no timers; a cell that lists this metric and
whose counters hold fewer than two cards' timers fails: a renamed timer
must not read as 0."""

import re

TIMER = re.compile(r"^drt\.tile\.c(\d+)\.device_ms$")


def read(record):
    if record["loop"] != "tiles":
        return None
    try:
        from dustraytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "device_timer"):
        return None
    ms = [v for k, v in profiling.counters("drt.tile.").items()
          if TIMER.match(k)]
    if len(ms) < 2:
        raise RuntimeError(f"tile_skew_pct.tiles4: {len(ms)} drt.tile.c*."
                           f"device_ms timers in the program's counters")
    return 100.0 * (max(ms) - min(ms)) / max(ms)
