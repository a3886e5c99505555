"""Reduction of a ``torch.profiler`` trace of the measured window.

:class:`Trace` reads the profile once: every device activity (kernels,
copies, fills; not the device-side copies of host annotations) with its
interval, its launching host op and that op's ancestors; the window's own
interval (the harness's ``bench.window`` span); and the host events of the
window's thread. The per-layer readers take their numbers from it:

* busy seconds: the union of device intervals inside the window;
* device time by the top-level aten op that launched it, by kernel name,
  and under any op whose name matches a test (``aten::convolution`` and
  its backward take in the convolutions' bias adds and layout copies);
* idle gaps: the complement of the union inside the window, each named
  by the benchmark's innermost ``bench.*`` span and the innermost host op
  running at its middle.
"""

import bisect

WINDOW_SPAN = "bench.window"


class Trace:
    """Digest of one profile (``prof`` of ``torch.profiler.profile``)."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        events = list(prof.events())
        host = [e for e in events if e.device_type == DeviceType.CPU
                and not e.is_async]
        windows = [e for e in host if e.name == WINDOW_SPAN]
        if not windows:
            raise ValueError(f"no {WINDOW_SPAN} span in the profile")
        win = windows[0]
        self.start_us, self.end_us = win.time_range.start, win.time_range.end
        self.thread = win.thread
        by_id = {e.id: e for e in host}
        # device activities from the raw events, whose link to the
        # launching host op every torch version keeps; their clock is
        # moved onto the host events' by the window span's two readings
        raw = list(prof.profiler.kineto_results.events())
        k_win = next(k for k in raw if k.name() == WINDOW_SPAN
                     and k.device_type() == DeviceType.CPU)
        offset = self.start_us - k_win.start_ns() / 1e3
        self.device = []  # (start, end, name, ancestor names)
        for k in raw:
            if k.device_type() != DeviceType.CUDA or k.is_user_annotation() \
                    or k.name().startswith("bench."):
                continue
            names = []
            op = by_id.get(k.linked_correlation_id())
            while op is not None:
                names.append(op.name)
                op = op.cpu_parent
            start = k.start_ns() / 1e3 + offset
            self.device.append((start, start + k.duration_ns() / 1e3,
                                k.name(), names))
        self.host = [(e.time_range.start, e.time_range.end, e.name)
                     for e in host if e.thread == self.thread
                     and e.name != WINDOW_SPAN]
        self._union = None

    @property
    def window_s(self):
        """Length of the measured window, s."""
        return (self.end_us - self.start_us) / 1e6

    def union(self):
        """Sorted, disjoint device-busy intervals clipped to the window."""
        if self._union is None:
            spans = sorted((max(s, self.start_us), min(e, self.end_us))
                           for s, e, _, _ in self.device)
            out = []
            for s, e in spans:
                if e <= s:
                    continue
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            self._union = out
        return self._union

    @property
    def busy_s(self):
        """Seconds in which some device activity ran, inside the window."""
        return sum(e - s for s, e in self.union()) / 1e6

    def device_s(self, match):
        """Device seconds of activities one of whose launching ops (or
        whose own name) satisfies ``match(name)``, inside the window."""
        total = 0.0
        for s, e, name, ops in self.device:
            if any(match(n) for n in ops) or match(name):
                total += max(min(e, self.end_us) - max(s, self.start_us), 0)
        return total / 1e6

    def count(self, match):
        """Device activities inside the window whose own name satisfies
        ``match``."""
        return sum(1 for s, e, name, _ in self.device
                   if match(name) and s >= self.start_us
                   and e <= self.end_us)

    def top_ops(self, n=10):
        """``[[name, seconds], ...]`` of the ``n`` largest device times by
        the outermost aten op that launched them (the kernel's own name
        where no aten op did)."""
        totals = {}
        for s, e, name, ops in self.device:
            aten = [o for o in ops if o.startswith("aten::")]
            key = aten[-1] if aten else name[:120]
            dur = max(min(e, self.end_us) - max(s, self.start_us), 0) / 1e6
            totals[key] = totals.get(key, 0.0) + dur
        rows = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in rows]

    def gaps(self, n=10):
        """``[[label, seconds], ...]`` of the ``n`` longest idle gaps of
        the device inside the window, each labelled by what the window's
        host thread was doing at its middle."""
        edges = [self.start_us]
        for s, e in self.union():
            edges += [s, e]
        edges.append(self.end_us)
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        starts = sorted(self.host)
        keys = [h[0] for h in starts]
        out = []
        for length, lo in gaps:
            mid = lo + length / 2
            hit = [h for h in starts[:bisect.bisect_right(keys, mid)]
                   if h[1] >= mid]
            spans = [h for h in hit if h[2].startswith("bench.")]
            ops = [h for h in hit if not h[2].startswith("bench.")]
            label = spans[-1][2] if spans else "outside spans"
            label += "/" + (ops[-1][2] if ops else "python")
            out.append([label, length / 1e6])
        return out
