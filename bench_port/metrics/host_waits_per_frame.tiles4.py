"""Host waits for any card per frame of the tiles loop inside the
program's calls (render_progressive over the mesh, film_image with its
gather): the synchronizing CUDA operations that
torch.cuda.set_sync_debug_mode("warn") reports, the harness's own
synchronize of every card left out."""


def read(record):
    if record["loop"] != "tiles":
        return None
    return record["waits"] / record["wait_units"]
