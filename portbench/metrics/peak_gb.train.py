"""The device memory peak of the window (`max_memory_allocated` after a
reset at the window's start), in GB of 1e9 bytes."""


def read(run):
    b = run.record.peak_bytes
    return b / 1e9 if b else None
