"""Device milliseconds per active op row in the traced call: the summed
durations of its device operations (torch.profiler)."""


def read(record):
    t = record.get("trace")
    if not t or not t["ops"]:
        return None
    return 1e3 * t["device_s"] / record["rows"]
