"""Peak device memory over the window (``max_memory_allocated`` after a
reset at the window's start), GiB."""


def read(record):
    return record["peak_bytes"] / 2 ** 30
