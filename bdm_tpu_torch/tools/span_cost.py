"""The host's cost of one span site (`bdm_tpu_torch.utils.spans`).

    python -m bdm_tpu_torch.tools.span_cost [--calls 200000]

Times entering and leaving one span `--calls` times on the calling
thread: with recording off (the shared no-op), with recording on and no
profiler running, and with recording on under a profiler that keeps the
spans alone (`user_spans`). Each figure is the loop's time a call less
that of the same loop without the span. Prints one JSON line: us a
site each way, the bare loop's us a call, and the torch version.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import torch

from bdm_tpu_torch.utils import spans


@contextlib.contextmanager
def user_spans(kept: list):
    """Profile the block on the CPU, keeping the host's `user_annotation`
    events alone (no operator is recorded); on exit `kept` holds them as
    (name, ts, dur) in the profiler's microseconds."""
    from torch._C._autograd import (_disable_profiler, _enable_profiler,
                                    _prepare_profiler)
    from torch._C._profiler import RecordScope
    from torch.autograd.profiler import profile
    p = profile(use_device=None, use_kineto=True)
    cfg, acts = p.config(), p.kineto_activities
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        yield kept
    finally:
        result = _disable_profiler()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            result.save(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        kept.extend((e["name"], float(e["ts"]), float(e["dur"]))
                    for e in events if e.get("cat") == "user_annotation")


def _loop_s(calls: int, with_span: bool) -> float:
    span = spans.span
    t = time.perf_counter()
    if with_span:
        for _ in range(calls):
            with span("network"):
                pass
    else:
        for _ in range(calls):
            pass
    return time.perf_counter() - t


def measure(calls: int) -> dict:
    bare = min(_loop_s(calls, False) for _ in range(3))

    def per_site(s):
        return (s - bare) / calls * 1e6

    off = per_site(min(_loop_s(calls, True) for _ in range(3)))
    with spans.recording():
        on = per_site(min(_loop_s(calls, True) for _ in range(3)))
        kept = []
        with user_spans(kept):
            profiled = per_site(_loop_s(calls, True))
    return {"off_us": off, "on_us": on, "profiled_us": profiled,
            "profiled_spans": len(kept), "bare_loop_us": bare / calls * 1e6,
            "calls": calls, "torch": torch.__version__}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m bdm_tpu_torch.tools.span_cost")
    p.add_argument("--calls", type=int, default=200_000)
    args = p.parse_args(argv)
    print(json.dumps(measure(args.calls)), flush=True)


if __name__ == "__main__":
    main()
