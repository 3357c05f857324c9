"""Device kernels launched per profiled frame (copies and fills left
out): how many dispatches the integrator makes."""


def read(record):
    if record["loop"] != "render":
        return None
    kernels = [n for n, _ in record["device_ops"]
               if not n.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise RuntimeError("kernels_per_frame.render: the profiled frames "
                           "hold no device kernel")
    return len(kernels) / record["units"]
