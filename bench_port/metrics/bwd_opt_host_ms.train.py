"""Host ms of the rest of train_step after the loss forward: autograd's
backward, Adam and project_params; the mean over the timed steps of the
window of (train_step's span - the forward's span)."""


def read(record):
    if record["loop"] != "train" or not record.get("fwd_s"):
        return None
    rest = [s - f for s, f in zip(record["step_s"], record["fwd_s"])]
    return 1e3 * sum(rest) / len(rest)
