"""Device kernels launched per profiled frame of the tiles loop, summed
over the four cards (copies and fills left out): how many dispatches the
integrator makes for one frame split into row bands, four times a
card's. A cell that lists this metric and whose profiled frames hold no
kernel fails."""


def read(record):
    if record["loop"] != "tiles":
        return None
    kernels = [n for n, _ in record["device_ops"]
               if not n.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise RuntimeError("kernels_per_frame.tiles4: the profiled frames "
                           "hold no device kernel")
    return len(kernels) / record["units"]
