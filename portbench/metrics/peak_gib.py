"""The allocator's peak over the window (GiB):
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's opening."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
