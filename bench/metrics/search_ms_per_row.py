"""Milliseconds of ``search_population`` (the exact search: mapper,
executor, cost model) per active op row walked (spans of a ``--trace 1``
run)."""


def read(record):
    s = [c["search_s"] for c in record["calls"] if "search_s" in c]
    if not s:
        return None
    return 1e3 * sum(s) / (len(s) * record["rows"])
