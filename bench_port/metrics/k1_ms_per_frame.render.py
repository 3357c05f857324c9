"""Device ms per frame of K1, the traversal kernel (kernels whose name
holds "traverse_sweep_kernel", ops/traverse_sweep.py). A cell that lists
this metric and shows no such kernel fails: a renamed kernel must not
read as 0."""

NAME = "traverse_sweep_kernel"


def read(record):
    if record["loop"] != "render":
        return None
    sec = [s for n, s in record["device_ops"] if NAME in n]
    if not sec:
        raise RuntimeError(f"k1_ms_per_frame.render: no kernel named "
                           f"*{NAME}* in the profiled frames")
    return 1e3 * sum(sec) / record["units"]
