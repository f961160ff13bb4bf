"""The program's own profiler spans (``repro_torch.trace``) in a profiled
window: the device time launched inside a span, the host syncs, the idle
time after them.

A device operation belongs to every program span whose host interval holds
the start of the CPU event that launched it, on any thread of the process:
the backward's kernels are launched from autograd's device thread while the
step's thread waits inside ``train.backward``.  Spans of one name are taken
as the union of their intervals, so a time lies in a name's span or not.

An operation launched outside the dispatcher (Triton's launcher calls
``cuLaunchKernelEx``) links to no CPU event (correlation id 0).  On the
program's one stream the device runs operations in launch order, so such an
operation was launched between the launches of the linked operations
before and after it: of the launch calls (``cu*LaunchKernel*``) in that
window, a run of ``k`` unlinked operations takes the last ``k``, in order
(the window's earlier calls launch the linked operation before it).  Where
the window holds fewer calls, the run was launched from inside the next
linked operation's CPU event, and takes its start.

The step's phases (``train.*``) tile it, so the operations of ``bench.step``
that lie in no phase are what the spans miss (:meth:`Spans.untiled_ns`).

The host syncs are read off the host's own calls that wait for the device
(``SYNC_CALLS``) inside ``bench.step``, not off the program's ``sync.*``
spans, so a program that drops or moves a span moves no count: the calls
inside one ``aten::`` op are one sync (:meth:`Spans.syncs`).  The spans
only name them; :meth:`Spans.unspanned_syncs` lists the syncs they miss.

A span's reading is ``None`` where the trace has no such span (a program
without them); the syncs are read wherever the trace has device operations.
"""

from __future__ import annotations

import bisect
import functools

PHASE = "train."
SYNC = "sync."
STEP = "bench.step"
# host calls that wait for the device (a device-to-host copy's sync among them)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")  # and their Ex variants


def _union(intervals: list) -> tuple[list, list]:
    """Sorted, merged ``(starts, ends)``."""
    starts, ends = [], []
    for s, e in sorted(intervals):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


class Spans:
    def __init__(self, trace):
        self.trace = trace
        raw: dict[str, list] = {}
        for name, _, s, e in trace.cpu:
            raw.setdefault(name, []).append((s, e))
        self.count = {k: len(v) for k, v in raw.items()}
        self._union = {k: _union(v) for k, v in raw.items()}
        self._named: dict[str, list] = {}
        self._launched: list | None = None
        self._syncs: list | None = None

    def named(self, prefix: str) -> list[str]:
        """The span names that start with ``prefix``, sorted."""
        if prefix not in self._named:
            self._named[prefix] = sorted(k for k in self.count if k.startswith(prefix))
        return self._named[prefix]

    def holds(self, name: str, t: int) -> bool:
        """Whether a span ``name`` is open at host time ``t``."""
        u = self._union.get(name)
        if u is None:
            return False
        i = bisect.bisect_right(u[0], t) - 1
        return i >= 0 and t <= u[1][i]

    def holds_prefix(self, prefix: str, t: int) -> bool:
        return any(self.holds(k, t) for k in self.named(prefix))

    def launched(self) -> list[tuple[int, int]]:
        """``(host launch time, device ns)`` of each device operation whose
        launch the trace shows (module docstring)."""
        if self._launched is None:
            calls = sorted(s for name, _, s, _ in self.trace.cpu if name.startswith(LAUNCH_CALLS))
            out, run, prev = [], [], None
            for _, s, e, corr in self.trace.device:
                op = self.trace.ops.get(corr) if corr else None
                if op is None:
                    run.append(e - s)
                    continue
                if run:
                    out += self._place(run, calls, prev, op[1])
                    run = []
                out.append((op[1], e - s))
                prev = op[1]
            if run:
                out += self._place(run, calls, prev, None)
            self._launched = out
        return self._launched

    @staticmethod
    def _place(run: list, calls: list, lo, hi) -> list[tuple[int, int]]:
        """The run of unlinked operations' ``(launch, ns)``: the last
        ``len(run)`` launch calls in ``(lo, hi)``, else ``hi`` (none after
        the last linked operation)."""
        i = 0 if lo is None else bisect.bisect_right(calls, lo)
        j = len(calls) if hi is None else bisect.bisect_left(calls, hi)
        if j - i >= len(run):
            return list(zip(calls[j - len(run):j], run))
        return [] if hi is None else [(hi, ns) for ns in run]

    def device_ns(self, inside: str, outside: tuple[str, ...] = ()) -> int:
        """Device ns of the operations launched inside a span ``inside`` and
        inside no span of ``outside``."""
        return sum(ns for t, ns in self.launched()
                   if self.holds(inside, t) and not any(self.holds(o, t) for o in outside))

    def untiled_ns(self) -> int:
        """Device ns of the operations launched inside ``bench.step`` and
        inside no phase span: the step's work that the phases miss."""
        return sum(ns for t, ns in self.launched()
                   if self.holds(STEP, t) and not self.holds_prefix(PHASE, t))

    def syncs(self) -> list[tuple]:
        """``(thread, start, end, op, waits)`` of each host sync inside
        ``bench.step``: the outermost ``aten::`` op around one or more calls
        that wait for the device, on their thread (``op`` its name), or one
        such call in no op (``op`` ""); ``waits`` the ``(call, start, end)``
        of its calls."""
        if self._syncs is None:
            groups: dict[tuple, list] = {}
            for name, thread, s, e in self.trace.cpu:
                if name not in SYNC_CALLS or not self.holds(STEP, s):
                    continue
                ops = [(cs, ce, cn) for cn, th, cs, ce in self.trace.cpu
                       if th == thread and cs <= s and e <= ce and cn.startswith("aten::")]
                cs, ce, cn = min(ops) if ops else (s, e, "")
                groups.setdefault((thread, cs, ce, cn), []).append((name, s, e))
            self._syncs = [(th, cs, ce, cn, sorted(w, key=lambda c: c[1]))
                           for (th, cs, ce, cn), w in sorted(groups.items())]
        return self._syncs

    def sync_idle_ns(self) -> int:
        """Device idle ns in the gaps that open while the host is in a sync,
        from its first wait on, and close after the wait they open in (or
        follow) returns: the device drained its queue at the sync and waits
        for the host's next launches, inside the sync's op or after it.
        (The gaps between the queued operations the host waits for close
        inside the wait.)"""
        iv = self.trace.intervals()
        ends = [e for _, e in iv]
        gaps = set()
        for _, _, end, _, waits in self.syncs():
            i = bisect.bisect_left(ends, waits[0][1])
            while i + 1 < len(iv) and ends[i] <= end:
                w = max(e for _, s, e in waits if s <= ends[i])
                if iv[i + 1][0] > w:
                    gaps.add(i)
                i += 1
        return sum(iv[i + 1][0] - ends[i] for i in gaps)

    def unspanned_syncs(self) -> list[list]:
        """``[calls, phase, op, host ns waiting]`` of each sync that starts
        inside no ``sync.*`` span: its calls' names, the phase span open at
        its start ("" for none) and its ``aten::`` op."""
        out = []
        for _, s, _, op, waits in self.syncs():
            if self.holds_prefix(SYNC, s):
                continue
            phase = next((k for k in self.named(PHASE) if self.holds(k, s)), "")
            out.append(["+".join(c for c, _, _ in waits), phase, op,
                        sum(e - b for _, b, e in waits)])
        return out


@functools.lru_cache(maxsize=1)
def of(trace) -> Spans:
    """The spans of ``trace`` (built once for the readers of one run)."""
    return Spans(trace)


def device_ms_per_step(ctx, inside: str, outside: tuple[str, ...] = ()):
    """Device ms per profiled step launched inside ``inside`` (less
    ``outside``); None without a trace, a device operation or a span
    ``inside``."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    spans = of(ctx.trace)
    if inside not in spans.count:
        return None
    return spans.device_ns(inside, outside) / 1e6 / ctx.profiled_steps
