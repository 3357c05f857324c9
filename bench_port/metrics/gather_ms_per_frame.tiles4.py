"""Device ms a profiled frame of the tile gather: film_image's copies of
cards 1-3's tiles onto card 0, the profiled frames' peer-to-peer memcpy
operations ("Memcpy PtoP" in the profiler's names). The tiles loop makes
each view's camera on every card from the host, so the gather's are the
only copies between cards in a frame. A cell that lists this metric and
shows no such copy fails: a renamed operation must not read as 0."""

NAME = "Memcpy PtoP"


def read(record):
    if record["loop"] != "tiles":
        return None
    sec = [s for n, s in record["device_ops"] if n.startswith(NAME)]
    if not sec:
        raise RuntimeError(f"gather_ms_per_frame.tiles4: no device "
                           f"operation named {NAME}* in the profiled frames")
    return 1e3 * sum(sec) / record["units"]
