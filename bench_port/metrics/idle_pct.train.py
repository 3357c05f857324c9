"""Device idle share of a train cell's profiled steps: 100 (1 - the
union of device-operation intervals / the steps' wall time)."""


def read(record):
    if record["loop"] != "train":
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
