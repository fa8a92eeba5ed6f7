"""peak_gib.<mode>: the device memory the window's calls held at most,
torch.cuda.max_memory_allocated after reset_peak_memory_stats at the
window's start, in GiB."""


def read(rec: dict, name: str) -> float | None:
    return rec["peak_window_bytes"] / 2**30 if rec["peak_window_bytes"] else None
