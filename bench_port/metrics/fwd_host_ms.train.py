"""Host ms of the loss forward in a step (make_loss_fn's loss_fn through
render_pixels), a host-clock span around the call that adds no
synchronize; the mean over the timed steps of the window."""


def read(record):
    if record["loop"] != "train" or not record.get("fwd_s"):
        return None
    return 1e3 * sum(record["fwd_s"]) / len(record["fwd_s"])
