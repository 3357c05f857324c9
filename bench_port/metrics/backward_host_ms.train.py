"""Host ms a step of the backward: the duration of the program's
drt.step.backward spans (train_step's loss.backward(), the drt.bwd.*
spans inside it), summed over the profiled steps and divided by their
drt.step spans. It reads the program's span table
(dustraytracer_tpu_torch/utils/profiling.py), which the profiled steps
fill. None where the program has no span table; a cell that lists this
metric and whose table lacks a span fails: a renamed span must not read
as 0."""

SPANS = ("drt.step.backward",)
UNIT = "drt.step"


def read(record):
    if record["loop"] != "train":
        return None
    try:
        from dustraytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "span_totals"):
        return None
    totals = profiling.span_totals()
    missing = [n for n in SPANS + (UNIT,)
               if not totals.get(n, {}).get("count")]
    if missing:
        raise RuntimeError(f"backward_host_ms.train: no span {missing} in "
                           f"the program's span table")
    return (sum(totals[n]["total_ms"] for n in SPANS)
            / totals[UNIT]["count"])
