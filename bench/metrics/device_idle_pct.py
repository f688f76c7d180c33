"""Share of the traced call's host-clock time in which no operation ran
on the device, %."""


def read(record):
    t = record.get("trace")
    if not t or not t["ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
