"""K4's share of its roofline in a train step: the least time the
albedo gradient's bytes need at the card's memory bandwidth
(arith.k4_material_bytes / arith.HBM_BYTES_PER_S), over the device time
of the kernels whose name holds "rows_grad" (ops/rows.py) per step. A
cell that lists this metric and shows no such kernel fails: a renamed
kernel must not read as 0."""

from bench_port import arith

NAME = "rows_grad"


def read(record):
    if record["loop"] != "train":
        return None
    sec = [s for n, s in record["device_ops"] if NAME in n]
    if not sec:
        raise RuntimeError(f"k4_roofline.train: no kernel named "
                           f"*{NAME}* in the profiled steps")
    bound = arith.k4_material_bytes(
        record["width"], record["height"], record["bounces"],
        record["n_materials"]) / arith.HBM_BYTES_PER_S
    return 100.0 * bound / (sum(sec) / record["units"])
