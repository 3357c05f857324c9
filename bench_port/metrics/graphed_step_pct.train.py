"""Share of the profiled steps that replayed the captured step: 100
drt.step.replayed / drt.step spans. drt.step.replayed is the program's
host counter (dustraytracer_tpu_torch/apps/optimize.py train_step;
counted while spans are on, so over the profiled steps alone), drt.step
its span around each train_step call. 0 where the program has the
counters but replays no step (every step eager); None where it has no
counter table. A cell that lists this metric and whose span table has no
drt.step fails: a renamed span must not read as 0."""

UNIT = "drt.step"
COUNTER = "drt.step.replayed"


def read(record):
    if record["loop"] != "train":
        return None
    try:
        from dustraytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "counters"):
        return None
    units = profiling.span_totals().get(UNIT, {}).get("count", 0)
    if not units:
        raise RuntimeError(f"graphed_step_pct.train: no span {UNIT} in the "
                           f"program's span table")
    return 100.0 * profiling.counters("drt.step.").get(COUNTER, 0) / units
