"""Device operations (kernels, copies, fills) per active op row in the
traced call (torch.profiler)."""


def read(record):
    t = record.get("trace")
    if not t or not t["ops"]:
        return None
    return t["ops"] / record["rows"]
