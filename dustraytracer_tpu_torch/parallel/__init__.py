"""Parallel rendering (port of parallel/). Only `apply_params`, the
parameter overlay of the inverse-rendering step, is ported; the
tile-sharded render and the gradient all-reduce are not yet."""
