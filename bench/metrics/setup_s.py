"""Seconds from the start of ``bench/run.py`` to the first timed call:
importing torch and the port, preparing the workloads, drawing the
genome pool and one warm call at the cell's size."""


def read(record):
    return record["setup_s"]
