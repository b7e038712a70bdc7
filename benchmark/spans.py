"""The spans stretch: the program's own spans (`bdm_tpu_torch.utils.spans`)
read from one traced stretch.

`SpanStretch` keeps the contract of `trace.Stretch`: `start()` and
`stop()` each wait for the device, so the stretch holds exactly the work
issued inside it. Inside it the program's spans record
(`spans.recording()`), and the profiler keeps the device's kernels and
copies, the CUDA runtime's calls and, of the host's events, the spans
alone (`RecordScope.USER_SCOPE`, `user_annotation` events): no host
operation is recorded. The host runs as in the untraced window
(`harness.quiet_host`: the collector frozen and off, the thread on one
core), so the idle time read is the program's and not the collector's
pauses over the traces the benchmark holds. A program without spans runs
the stretch all the same, and its table holds the row `(none)` alone.

`reduce_spans` ties each device event to its runtime call through
`args.correlation`, and each runtime call to the spans that hold its
timestamp on the thread that made it (host and device events are on one
clock, the profiler's). A launch, a device event or an idle gap counts as
`self` in the innermost span and as inclusive in every span around it;
work outside every span is the row `(none)`. An idle gap is the time the
device waits before an event, counted for the launch of that event. So
every figure compares host times with host times and device times with
device times. Two counts check the trace: device events whose runtime
call was not found (`unmatched`, attributed to `(none)`), and device
events that start before their runtime call (`early`, the most by which
one does in `lead_us`), which read 0 only where the profiler carries the
device's times onto the host's clock without drift.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List

import torch

from benchmark.harness import quiet_host
from benchmark.trace import DEVICE_CATS, LAUNCHES

NONE = "(none)"
FIELDS = ("calls", "launches", "launches_self", "device_us",
          "device_us_self", "idle_us", "idle_us_self")


def _recording():
    """The program's `spans.recording()`, or nothing for a program that
    has no spans."""
    try:
        from bdm_tpu_torch.utils import spans
    except ImportError:
        return contextlib.nullcontext()
    return spans.recording()


class SpanStretch:
    """Profile the work between `start()` and `stop()` with the program's
    spans on and no host operation recorded."""

    def __init__(self):
        self.held = None
        self.wall_s = None
        self.events = None

    def start(self) -> None:
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import RecordScope
        from torch.autograd.profiler import profile
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.held = contextlib.ExitStack()
        self.held.enter_context(quiet_host())
        self.held.enter_context(_recording())
        # use_kineto: without it some versions time the device by CUDA
        # events around each recorded host operation and keep no kernel
        p = profile(use_device="cuda" if cuda else None, use_kineto=True)
        cfg, acts = p.config(), p.kineto_activities
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Stop and write the trace out at once: a later profiler session
        in the process clears this one's events."""
        from torch._C._autograd import _disable_profiler
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        result = _disable_profiler()
        self.held.close()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            result.save(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)

    def table(self, steps: int) -> dict:
        events, self.events = self.events, None
        out = reduce_spans(events, steps)
        out["wall_s"] = self.wall_s
        return out


def _chains(spans_by_tid, queries) -> Dict[int, tuple]:
    """For each query (key, tid, ts), the names of the spans on thread
    `tid` that hold `ts`, outermost first. Spans of a thread nest, so one
    sweep in time with a stack of the open spans answers every query."""
    out = {}
    by_tid = collections.defaultdict(list)
    for key, tid, ts in queries:
        by_tid[tid].append((ts, key))
    for tid, qs in by_tid.items():
        spans = spans_by_tid.get(tid, [])
        stack, i = [], 0
        for ts, key in sorted(qs):
            while i < len(spans) and spans[i][0] <= ts:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[key] = tuple(s[2] for s in stack)
    return out


def reduce_spans(events: List[dict], steps: int) -> dict:
    """-> {"steps", "launches", "device_us", "idle_us", "calls",
    "unmatched", "early", "rows": {span: {FIELDS}}}: totals over the
    stretch, times in microseconds; `calls` counts span events."""
    spans_by_tid = collections.defaultdict(list)
    runtime, launches, dev = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation":
            ts = float(e["ts"])
            spans_by_tid[e.get("tid")].append(
                (ts, ts + float(e["dur"]), e["name"]))
        elif cat in DEVICE_CATS:
            dev.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                runtime[corr] = e
            if e.get("name") in LAUNCHES:
                launches.append(e)
    for s in spans_by_tid.values():
        s.sort(key=lambda x: (x[0], -x[1]))
    queries = [(id(e), e.get("tid"), float(e["ts"])) for e in launches]
    calls_of = {}
    unmatched = early = 0
    lead_us = 0.0
    for e in dev:
        r = runtime.get(e.get("args", {}).get("correlation"))
        if r is None:
            unmatched += 1
            continue
        calls_of[id(e)] = id(r)
        queries.append((id(r), r.get("tid"), float(r["ts"])))
        early += float(e["ts"]) < float(r["ts"])
        lead_us = max(lead_us, float(r["ts"]) - float(e["ts"]))
    chains = _chains(spans_by_tid, queries)

    rows = collections.defaultdict(lambda: dict.fromkeys(FIELDS, 0))

    def add(chain, name, value):
        rows[chain[-1] if chain else NONE][name + "_self"] += value
        for n in (set(chain) if chain else {NONE}):
            rows[n][name] += value

    for s in spans_by_tid.values():
        for _, _, name in s:
            rows[name]["calls"] += 1
    for e in launches:
        add(chains[id(e)], "launches", 1)

    def chain_of(e):
        r = calls_of.get(id(e))
        return chains[r] if r is not None else ()

    device_us = idle_us = 0.0
    order = sorted(dev, key=lambda e: float(e["ts"]))
    end = None
    for e in order:
        ts, dur = float(e["ts"]), float(e["dur"])
        chain = chain_of(e)
        add(chain, "device_us", dur)
        device_us += dur
        if end is not None and ts > end:
            add(chain, "idle_us", ts - end)
            idle_us += ts - end
        end = ts + dur if end is None else max(end, ts + dur)
    return {"steps": steps, "launches": len(launches),
            "device_us": device_us, "idle_us": idle_us,
            "calls": sum(r["calls"] for r in rows.values()),
            "unmatched": unmatched, "early": early, "lead_us": lead_us,
            "rows": {k: dict(v) for k, v in rows.items()}}


def lines(table: dict) -> List[str]:
    """The table a step, one line a span, the most device time first."""
    n = table["steps"]
    out = [f"span: calls / launches self, incl / device ms self, incl / "
           f"idle ms self, incl; a step of {n}"]
    for name, r in sorted(table["rows"].items(),
                          key=lambda kv: -kv[1]["device_us"]):
        out.append(
            f"  {name}: {r['calls'] / n:.2f} / {r['launches_self'] / n:.2f}, "
            f"{r['launches'] / n:.2f} / {r['device_us_self'] / n / 1e3:.4f}, "
            f"{r['device_us'] / n / 1e3:.4f} / "
            f"{r['idle_us_self'] / n / 1e3:.4f}, "
            f"{r['idle_us'] / n / 1e3:.4f}")
    out.append(f"  all: {table['calls'] / n:.2f} span calls, "
               f"{table['launches'] / n:.2f} launches, "
               f"{table['device_us'] / n / 1e3:.4f} device ms, "
               f"{table['idle_us'] / n / 1e3:.4f} idle ms a step; "
               f"unmatched {table['unmatched']}, early {table['early']} "
               f"(by up to {table['lead_us']:.1f} us)")
    return out
