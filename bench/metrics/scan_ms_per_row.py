"""Milliseconds of ``batch_evaluate`` (the scan evaluator) per active op
row walked (spans of a ``--trace 1`` run)."""


def read(record):
    s = [c["scan_s"] for c in record["calls"] if "scan_s" in c]
    if not s:
        return None
    return 1e3 * sum(s) / (len(s) * record["rows"])
