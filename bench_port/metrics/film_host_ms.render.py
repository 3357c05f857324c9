"""Host ms a frame of the film: the self time of the program's drt.frame
spans (render_progressive less its samples: the light and camera copies,
the film's set-up) plus drt.film_add and drt.film_image, summed over the
profiled frames and divided by their drt.frame spans. It reads the
program's span table (dustraytracer_tpu_torch/utils/profiling.py), which
the profiled frames fill. None where the program has no span table; a
cell that lists this metric and whose table lacks a span fails: a
renamed span must not read as 0."""

SPANS = ("drt.frame", "drt.film_add", "drt.film_image")
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
    missing = [n for n in SPANS if not totals.get(n, {}).get("count")]
    if missing:
        raise RuntimeError(f"film_host_ms.render: no span {missing} in the "
                           f"program's span table")
    return (sum(totals[n]["self_ms"] for n in SPANS)
            / totals[UNIT]["count"])
