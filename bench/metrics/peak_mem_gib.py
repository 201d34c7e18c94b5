"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the window, the
peak reset just before it (the graph and inputs resident, nothing of the
reference's on the card yet)."""


def read(run):
    if run.peak_window_bytes <= 0:
        return None
    return run.peak_window_bytes / 2**30
