"""A profiler trace (``torch.profiler``'s Chrome trace events) reduced to
what the readers ask: device operations within the span ``bench.window``,
the host launch of each, and the host's spans and operators.

Device operations are kernels, copies and sets; a device operation is tied
to its host launch by the trace's correlation id. Times in the trace are
microseconds on one clock for host and device.
"""

import bisect
from collections import defaultdict

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."


class _Outermost:
    """The outermost host operators of each thread, for lookups by time."""

    def __init__(self, events):
        by_tid = defaultdict(list)
        for e in sorted(events, key=lambda e: e["ts"]):
            rows = by_tid[e["tid"]]
            if not rows or e["ts"] >= rows[-1][1]:
                rows.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        self.rows = dict(by_tid)
        self.starts = {tid: [r[0] for r in rows] for tid, rows in self.rows.items()}

    def at(self, tid, t):
        rows = self.rows.get(tid, [])
        i = bisect.bisect_right(self.starts.get(tid, []), t) - 1
        return rows[i][2] if i >= 0 and rows[i][1] >= t else None


class Trace:
    def __init__(self, events, steps):
        self.steps = steps
        complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
        window = [e for e in complete if e.get("cat") == "user_annotation"
                  and e["name"] == SPAN_PREFIX + "window"]
        if not window:
            raise ValueError("the trace holds no span bench.window")
        self.start = window[0]["ts"]
        self.end = self.start + window[0]["dur"]
        launch = {e["args"]["correlation"]: e for e in complete
                  if e.get("cat") in LAUNCH and "correlation" in e.get("args", {})}
        self.ops = []  # (name, start, end, launch event or None), clipped to the window
        for e in complete:
            if e.get("cat") not in DEVICE:
                continue
            start, end = max(e["ts"], self.start), min(e["ts"] + e["dur"], self.end)
            if end > start:
                self.ops.append((e["name"], start, end,
                                 launch.get(e.get("args", {}).get("correlation"))))
        self.ops.sort(key=lambda op: op[1])
        self.spans = [e for e in complete if e.get("cat") == "user_annotation"
                      and e["name"].startswith(SPAN_PREFIX)]
        self.host_ops = _Outermost([e for e in complete if e.get("cat") == "cpu_op"])

    @property
    def window_s(self):
        return (self.end - self.start) / 1e6

    def busy_intervals(self):
        merged = []
        for _, start, end, _ in self.ops:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    @property
    def busy_s(self):
        return sum(end - start for start, end in self.busy_intervals()) / 1e6

    def device_s(self, match):
        """Seconds of device operations whose name ``match`` accepts."""
        return sum(end - start for name, start, end, _ in self.ops if match(name)) / 1e6

    def span_at(self, t, tid=None):
        """The innermost harness span open at host time ``t``."""
        inner = None
        for s in self.spans:
            if s["ts"] <= t <= s["ts"] + s["dur"] and (tid is None or s["tid"] == tid):
                if inner is None or s["ts"] >= inner["ts"]:
                    inner = s
        return inner["name"] if inner else None

    def device_s_under(self, span):
        """Seconds of device operations launched while the host was inside
        a harness span named ``span``."""
        opened = [(s["ts"], s["ts"] + s["dur"]) for s in self.spans if s["name"] == span]
        if not opened:
            return None
        return sum(end - start for _, start, end, lau in self.ops
                   if lau and any(a <= lau["ts"] <= b for a, b in opened)) / 1e6

    def idle_gaps(self):
        """[(seconds, what the host was doing)]: each stretch of the window
        with no device operation, named by the harness span and the
        outermost host operator that launched the operation ending it."""
        gaps, last = [], self.start
        ends_at = {op[1]: op for op in self.ops}
        for start, end in self.busy_intervals() + [[self.end, self.end]]:
            if start > last:
                op = ends_at.get(start)
                lau = op[3] if op else None
                if lau is None:
                    what = "window end" if start >= self.end else "unlaunched"
                else:
                    span = self.span_at(lau["ts"]) or "outside spans"
                    what = f"{span}/{self.host_ops.at(lau['tid'], lau['ts']) or 'python'}"
                gaps.append(((start - last) / 1e6, what))
            last = max(last, end)
        return gaps

    def breakdown(self, top=10):
        """The device operations that took most time and the idle time by
        what the host was doing, each summed over the window."""
        ops, idle = defaultdict(float), defaultdict(float)
        for name, start, end, _ in self.ops:
            ops[name] += (end - start) / 1e6
        for seconds, what in self.idle_gaps():
            idle[what] += seconds
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
