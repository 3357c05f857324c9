"""95th percentile of a train cell's step times over every step of the
window, in ms: the host clock from the start of `train_step` to its
loss read on the host (TrainLoop.e2e's `train_step_ms_p95`). It stands
per layer because the chip machine's host speed spreads that tail too
widely for an end-to-end bound."""

from bench_port import arith


def read(record):
    if record["loop"] != "train" or not record.get("unit_s"):
        return None
    return 1e3 * arith.percentile(record["unit_s"], 95)
