"""(genome, workload) pairs scored per second of the window: a call that
ends inside the window counts all its pairs, the call that runs past its
end counts them in proportion to its time inside; over the window's
length.  Unmappable pairs (scored inf) count as scored."""


def read(record):
    window = record["window_s"]
    work = 0.0
    for c in record["calls"]:
        inside = min(c["end_s"], window) - c["start_s"]
        work += c["pairs"] * max(inside, 0.0) / c["wall_s"]
    return work / window
