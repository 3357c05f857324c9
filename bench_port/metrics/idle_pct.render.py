"""Device idle share of a render cell's profiled frames: 100 (1 - the
union of device-operation intervals / the frames' wall time)."""


def read(record):
    if record["loop"] != "render":
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
