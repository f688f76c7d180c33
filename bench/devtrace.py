"""The profiler's reading of one whole call, as the per-layer device
metrics and the result's ``breakdown`` use it.

Taken from ``chip_smoke.py``'s ``_trace`` and ``_device_ms`` (torch.profiler
with CPU and CUDA activities, device time summed by kernel name), with
two changes: the events are read raw from the profiler's results (one
call launches some hundreds of thousands of kernels, too many to build
``FunctionEvent`` trees for), and the busy time is the union of the
device operations' intervals, so overlapping operations count once.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple


def _top(totals: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:n]]


def _label(t: int, host: List[Tuple[int, int, str]], starts: List[int],
           spans: List[Tuple[int, int, str]]) -> str:
    """What the host was doing at ``t``: the innermost benchmark span and
    the innermost host event that covers it."""
    span = "outside evaluate"
    for s, e, name in spans:
        if s <= t < e:
            span = name
    op = "no host event"
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        s, e, name = host[j]
        if e > t:
            op = name
            break
    return f"{span} > {op}"


def _add_gap(a: int, b: int, host, starts, spans, gaps) -> None:
    """Charge the idle interval [a, b) to what the host was doing at its
    start, split where a benchmark span begins or ends (so a gap that
    runs from the search into ``evaluate``'s own work is charged to
    both)."""
    cuts = sorted({x for s, e, _ in spans for x in (s, e) if a < x < b})
    for x, y in zip([a] + cuts, cuts + [b]):
        lab = _label(x, host, starts, spans)
        gaps[lab] = gaps.get(lab, 0.0) + (y - x) / 1e9


def summarize(device: List[Tuple[int, int, str]],
              host: List[Tuple[int, int, str]], window_s: float) -> Dict:
    """Busy time, operation count, device time and the breakdown from the
    device operations and host events (start ns, end ns, name) of one
    traced call that lasted ``window_s`` by the host's clock."""
    host.sort()
    spans = [h for h in host if h[2].startswith("bench.")]
    bounds = [h for h in spans if h[2] == "bench.evaluate"]
    lo = min(h[0] for h in bounds) if bounds else None
    hi = max(h[1] for h in bounds) if bounds else None
    device.sort()
    per_name: Dict[str, float] = {}
    busy, device_s = 0, 0
    gaps: Dict[str, float] = {}
    starts = [h[0] for h in host]
    cur_s = cur_e = None
    edge = lo
    for s, e, name in device:
        per_name[name] = per_name.get(name, 0.0) + (e - s) / 1e9
        device_s += e - s
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if edge is not None and s > edge:
                _add_gap(edge, s, host, starts, spans, gaps)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        edge = cur_e
    if cur_e is not None:
        busy += cur_e - cur_s
    if hi is not None and edge is not None and hi > edge:
        _add_gap(edge, hi, host, starts, spans, gaps)
    return {"busy_s": busy / 1e9, "window_s": window_s, "ops": len(device),
            "device_s": device_s / 1e9,
            "breakdown": {"device_ops": _top(per_name),
                          "idle_gaps": _top(gaps)}}


def _annotation(e) -> bool:
    """A ``record_function`` range mirrored on the device's timeline: no
    device operation.  (torch 2.11's events have no ``activity_type``.)"""
    kind = getattr(e, "activity_type", None)
    if kind is not None and "annotation" in str(kind()):
        return True
    return e.is_user_annotation() or e.name().startswith("bench.")


def trace_call(torch, call: Callable[[], object], on_card: bool) -> Dict:
    """Run ``call`` (which ends in a device synchronisation) once under
    torch.profiler and summarize it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        row = (s, s + e.duration_ns(), e.name())
        if not str(e.device_type()).endswith("CUDA"):
            host.append(row)
        elif not _annotation(e):
            device.append(row)
    return summarize(device, host, window_s)
