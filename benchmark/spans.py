"""Shared arithmetic of the readers of the program's spans.

The port marks its stages with named spans (``utils.profiling.annotate``,
a ``record_function``). In a :class:`benchmark.trace.Trace` a span of the
window's thread is a host event in ``host``, and an ancestor of the
device activities launched inside it in ``device``. A reader returns
None without a trace, or where the spans it reads are absent (a program
that lacks them).
"""

from benchmark import readers


def _merged(intervals):
    """Sorted, disjoint ``[start, end]`` intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b):
    """Length shared by two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]), 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under_pct(rec, names):
    """Share of the traced window in which the device ran nothing while
    the window's host thread was inside a span named in ``names``, %."""
    t = readers.traced(rec)
    if t is None:
        return None
    spans = _merged((max(s, t.start_us), min(e, t.end_us))
                    for s, e, name in t.host if name in names)
    if not spans:
        return None
    inside = sum(e - s for s, e in spans)
    idle = inside - _overlap(spans, t.union())
    return 100.0 * idle / (t.end_us - t.start_us)


def device_ms_per_step(rec, match, span=None):
    """Device time a step of the activities one of whose launching ops
    satisfies ``match(name)``, ms; None where the window's host thread
    never entered ``span`` (where given) or nothing matched."""
    t = readers.traced(rec)
    steps = rec["counters"].get("steps")
    if t is None or not steps:
        return None
    if span is not None and not any(name == span for _, _, name in t.host):
        return None
    took = t.device_s(match)
    return 1e3 * took / steps if took else None
