"""Host ms a frame of the shading of every bounce: the self time of the
program's drt.b{i}.shade spans (the stage _shade: sky, the hit and
material fetches, the albedo), summed over the profiled frames and divided by
their drt.frame spans. It reads the program's span table
(dustraytracer_tpu_torch/utils/profiling.py), which the profiled frames
fill. None where the program has no span table; a cell that lists this
metric and whose table lacks the span fails: a renamed span must not
read as 0."""

import re

SPANS = re.compile(r"drt\.b\d+\.shade")
UNIT = "drt.frame"


def read(record):
    if record["loop"] != "render":
        return None
    try:
        from dustraytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "span_totals"):
        return None
    totals = profiling.span_totals()
    found = [t for n, t in totals.items() if SPANS.fullmatch(n)]
    units = totals.get(UNIT, {}).get("count", 0)
    if not found or not units:
        raise RuntimeError(f"shade_host_ms.render: no span {SPANS.pattern} "
                           f"or {UNIT} in the program's span table")
    return sum(t["self_ms"] for t in found) / units
