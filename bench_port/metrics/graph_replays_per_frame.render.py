"""CUDA graphs replayed per profiled frame: the program's
drt.graph.replays counter (render/graphed.py; counted while spans are
on, so over the profiled frames alone) over the profiled frames'
drt.frame spans. 0 where the program has the counters but replays no
graph (it dispatches every op eagerly); None where it has no counter
table. A cell that lists this metric and whose span table has no
drt.frame fails: a renamed span must not read as 0."""

UNIT = "drt.frame"
COUNTER = "drt.graph.replays"


def read(record):
    if record["loop"] != "render":
        return None
    try:
        from dustraytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "counters"):
        return None
    units = profiling.span_totals().get(UNIT, {}).get("count", 0)
    if not units:
        raise RuntimeError(f"graph_replays_per_frame.render: no span {UNIT} "
                           f"in the program's span table")
    return profiling.counters("drt.graph.").get(COUNTER, 0) / units
