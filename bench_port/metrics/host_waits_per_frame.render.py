"""Host waits for the card per frame inside the program's calls
(render_progressive, film_image): the synchronizing CUDA operations that
torch.cuda.set_sync_debug_mode("warn") reports, the harness's own
synchronize left out."""


def read(record):
    if record["loop"] != "render":
        return None
    return record["waits"] / record["wait_units"]
