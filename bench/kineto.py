"""One profiler window, read from the profiler's raw (Kineto) events.

The method of the program's smoke script (``chip_smoke.py``'s ``_Trace``):
``prof.profiler.kineto_results.events()`` gives every device operation and
every synchronous CPU event with its thread, start and end, and each device
operation names the CPU event that launched it by correlation id.  Building
``prof.events()``'s tree of Python objects would take tens of seconds over
the ~10^4 launches of a training step.

A device event whose name is also the name of a CPU event is the device
copy of a profiler span (``record_function``), not an operation, and is
left out.  Times are in nanoseconds on one clock for the host and the
device.
"""

from __future__ import annotations

import bisect
import json


class Trace:
    def __init__(self, device: list, ops: dict, cpu: list):
        self.cpu = cpu  # (name, thread, start, end)
        self.ops = ops  # correlation id -> (thread, start) of the launching CPU event
        spans = {c[0] for c in cpu}
        # (name, start, end, correlation id) of each device operation
        self.device = sorted((d for d in device if d[0] not in spans), key=lambda d: d[1])

    @classmethod
    def from_profiler(cls, torch, prof) -> "Trace":
        cuda, cpu_kind = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        names: dict[str, str] = {}

        def name(e):
            raw = e.name()
            if raw not in names:
                names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
            return names[raw]

        device, ops, cpu = [], {}, []
        for e in prof.profiler.kineto_results.events():
            if getattr(e, "is_hidden_event", lambda: False)():
                continue
            kind = e.device_type()
            if kind == cuda:
                device.append((name(e), e.start_ns(), e.end_ns(), e.linked_correlation_id()))
            elif kind == cpu_kind and not e.is_async() and e.start_thread_id() == e.end_thread_id():
                thread, start = e.start_thread_id(), e.start_ns()
                if e.linked_correlation_id() == 0:
                    ops[e.correlation_id()] = (thread, start)
                cpu.append((name(e), thread, start, e.end_ns()))
        return cls(device, ops, cpu)

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        """A trace saved as ``{"device": [...], "ops": [[corr, [thread, start]], ...],
        "cpu": [...]}`` (the tests' recorded trace)."""
        d = json.loads(text)
        return cls([tuple(x) for x in d["device"]], {k: tuple(v) for k, v in d["ops"]},
                   [tuple(x) for x in d["cpu"]])

    def intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, in order."""
        out: list[list[int]] = []
        for _, s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.intervals())

    def by_name(self) -> dict[str, list]:
        """``{name: [operations, ns]}``."""
        out: dict[str, list] = {}
        for name, s, e, _ in self.device:
            k = out.setdefault(name, [0, 0])
            k[0] += 1
            k[1] += e - s
        return out

    def matching_ns(self, patterns: list[str]) -> int:
        """Device time of the operations whose lower-cased name holds one of
        ``patterns`` (lower-case substrings)."""
        return sum(ns for name, (_, ns) in self.by_name().items()
                   if any(p in name.lower() for p in patterns))

    def span_ns(self, prefixes: tuple[str, ...]) -> tuple[int, int]:
        """``(spans, device ns)`` of the operations launched inside a CPU span
        whose name starts with one of ``prefixes``, on the span's thread."""
        ranges: dict[int, list] = {}
        for name, thread, start, end in self.cpu:
            if name.startswith(prefixes):
                ranges.setdefault(thread, []).append((start, end))
        for r in ranges.values():
            r.sort()
        starts = {t: [s for s, _ in r] for t, r in ranges.items()}
        ns = 0
        for _, s, e, corr in self.device:
            op = self.ops.get(corr)
            if op is None or op[0] not in ranges:
                continue
            i = bisect.bisect_right(starts[op[0]], op[1]) - 1
            # spans nest: the launch lies in the latest span that started before it
            # or in an enclosing one
            while i >= 0 and op[1] > ranges[op[0]][i][1]:
                i -= 1
            if i >= 0:
                ns += e - s
        return sum(map(len, ranges.values())), ns

    def _innermost(self, thread: int, t: int, prefix: str) -> str | None:
        """The innermost CPU span on ``thread`` covering ``t`` whose name
        starts with ``prefix``."""
        best = None
        for name, th, s, e in self.cpu:
            if th == thread and s <= t <= e and name.startswith(prefix) \
                    and (best is None or s > best[1]):
                best = (name, s)
        return None if best is None else best[0]

    def idle_gaps(self, span_prefix: str, top: int = 10) -> list[list]:
        """The longest idle stretches of the device between its first and last
        operation, ``[label, seconds]``: the label is the innermost span of
        ``span_prefix`` and the outermost CPU event on the thread of those
        spans at the gap's middle."""
        threads = [th for name, th, _, _ in self.cpu if name.startswith(span_prefix)]
        thread = max(set(threads), key=threads.count) if threads else None
        iv = self.intervals()
        gaps = sorted(((b[0] - a[1], (a[1] + b[0]) // 2) for a, b in zip(iv, iv[1:])),
                      key=lambda g: (-g[0], g[1]))[:top]
        out = []
        for ns, mid in gaps:
            if thread is None:
                label = "host"
            else:
                span = self._innermost(thread, mid, span_prefix) or "outside the step"
                op = None
                for name, th, s, e in self.cpu:  # the outermost op inside no span
                    if th == thread and s <= mid <= e and not name.startswith(span_prefix) \
                            and name != span:
                        if op is None or s < op[1]:
                            op = (name, s)
                label = span + (f" / {op[0]}" if op else "")
            out.append([label, ns / 1e9])
        return out
