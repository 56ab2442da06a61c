"""peak_mem_gib (GiB): torch.cuda.max_memory_allocated over the window,
the peak reset after set-up."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None
