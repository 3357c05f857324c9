"""Device ms per frame of K1, the traversal kernel (kernels whose name
holds "traverse_sweep_kernel", ops/traverse_sweep.py), summed over the
four cards of the tiles loop: the K1 work of a frame, which splitting it
into row bands should leave as large as on one card. A cell that lists
this metric and shows no such kernel fails: a renamed kernel must not
read as 0."""

NAME = "traverse_sweep_kernel"


def read(record):
    if record["loop"] != "tiles":
        return None
    sec = [s for n, s in record["device_ops"] if NAME in n]
    if not sec:
        raise RuntimeError(f"k1_ms_per_frame.tiles4: no kernel named "
                           f"*{NAME}* in the profiled frames")
    return 1e3 * sum(sec) / record["units"]
