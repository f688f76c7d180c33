"""Milliseconds per call that ``EvalEngine.evaluate`` spends outside its
backend calls (``search_population`` or ``batch_evaluate``): canonical
genomes, memo probes and puts, the configs' stacking and placement
(spans of a ``--trace 1`` run)."""


def read(record):
    calls = record["calls"]
    if not calls or not any("search_s" in c or "scan_s" in c
                            for c in calls):
        return None
    host = [c["wall_s"] - c.get("search_s", 0.0) - c.get("scan_s", 0.0)
            for c in calls]
    return 1e3 * sum(host) / len(host)
