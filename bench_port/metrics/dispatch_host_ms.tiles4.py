"""Host ms a profiled frame that one thread spends issuing the cards'
samples outside their stages: the self time of the program's
drt.tile.c{i} spans (render/film.py: the card switch, the device timer's
events; the replays and the film add are their child spans), summed over
the cards and divided by the drt.frame spans. None outside the tiles
loop or where the program has no span table; a cell that lists this
metric and whose table lacks the spans fails: a renamed span must not
read as 0."""

import re

SPAN = re.compile(r"^drt\.tile\.c\d+$")
UNIT = "drt.frame"


def read(record):
    if record["loop"] != "tiles":
        return None
    try:
        from dustraytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "span_totals"):
        return None
    totals = profiling.span_totals()
    cards = [t for n, t in totals.items() if SPAN.match(n)]
    units = totals.get(UNIT, {}).get("count", 0)
    if not cards or not units:
        raise RuntimeError("dispatch_host_ms.tiles4: no drt.tile.c* or "
                           f"{UNIT} span in the program's span table")
    return sum(t["self_ms"] for t in cards) / units
