"""CUDA graphs replayed per profiled frame over all the cards: the
program's drt.graph.replays counter (render/graphed.py; counted while
spans are on) over the profiled frames' drt.frame spans. Four cards of
ten graphs a sample read 40; a card that renders eagerly shows as less.
None outside the tiles loop or where the program has no counters; a
cell that lists this metric and whose span table has no drt.frame
fails: a renamed span must not read as 0."""

UNIT = "drt.frame"
COUNTER = "drt.graph.replays"


def read(record):
    if record["loop"] != "tiles":
        return None
    try:
        from dustraytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "counters"):
        return None
    units = profiling.span_totals().get(UNIT, {}).get("count", 0)
    if not units:
        raise RuntimeError(f"graph_replays_per_frame.tiles4: no span {UNIT} "
                           f"in the program's span table")
    return profiling.counters("drt.graph.").get(COUNTER, 0) / units
