"""The program's time by span in one cell: the table a `SpanStretch`
reads (`benchmark/spans.py`) and the four metrics read from it.

    python3 -m benchmark.span_table --workload <name> --seed <n> \
        [--seconds <s>]

From the root of a checkout that holds the port, on a card. It runs the
cell's driver as `python3 -m benchmark.run --trace 1` does, with one
difference: the stretch that would record the host's operations (the
driver's `Stretch(host_ops=True)`) is a spans stretch instead, so the
program's spans record over the same forwards of the traced slice and no
host operation is recorded. The driver's log line on that stretch then
gives its ms a step beside the timed stretch's: the cost of recording
the spans. Standard error gets the driver's log and the table, one line
a span; the last line of standard output is one JSON object: `correct`,
the four metrics (`METRICS`, each read by its file under
`benchmark/metrics/`), the table (times in microseconds over the
stretch) and the spans stretch's and the timed stretch's wall.

The benchmark's own runs hold no spans stretch. Making it one of theirs
takes a third stretch in the driver (`drivers/blending.py`) and entries
for `METRICS` in `BENCHMARK.json`; the readers are written for that.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict  # noqa: E402

from benchmark import harness, manifest, trace  # noqa: E402
from benchmark.spans import SpanStretch, lines  # noqa: E402

METRICS = ("devoxelize_ms.sample", "groupnorm_ms.sample",
           "sampler_launches.sample", "forward_idle_ms.sample")


def readers() -> Dict[str, Callable]:
    """The reader of each of `METRICS`, found as `manifest` finds the
    reader of a metric that `BENCHMARK.json` lists."""
    out = {}
    for m in METRICS:
        base, _, kind = m.partition(".")
        read = manifest._load_module(
            manifest.ROOT / "benchmark" / "metrics" / f"{base}.py",
            "benchmark_metric_").read
        out[m] = manifest._of_kind(read, kind)
    return out


class NamedSpans(SpanStretch):
    """A spans stretch where the driver takes a stretch with the host's
    operations: its `summary` is `trace.reduce`'s over the same events
    (with no host operation, every idle gap reads "no host op"), and it
    keeps the table by span in `spans`."""

    made = []

    def __init__(self):
        super().__init__()
        self.spans = None
        NamedSpans.made.append(self)

    def summary(self, steps: int, own: set) -> trace.Summary:
        events = self.events
        self.spans = self.table(steps)
        return trace.reduce(events, steps, self.wall_s, own)


def stretch(host_ops: bool = False):
    """`trace.Stretch`'s constructor, with `NamedSpans` for `host_ops`."""
    return NamedSpans() if host_ops else trace.Stretch()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.span_table")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    args = p.parse_args(argv)
    cell = manifest.load(args.workload)
    harness.cache_dirs(cell.root)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    driver = cell.driver()
    driver.Stretch = stretch
    outcome = driver.run(cell, args.seed, args.seconds, True, False,
                         torch.device("cuda", 0), T0)
    if not NamedSpans.made or NamedSpans.made[-1].spans is None:
        print(f"{cell.name}: the driver took no stretch with the host's "
              f"operations", file=sys.stderr)
        return 1
    s = NamedSpans.made[-1]
    outcome.notes["spans"] = s.spans
    for line in lines(s.spans):
        print(f"{cell.name}: {line}", file=sys.stderr)
    metrics = {m: read(outcome) for m, read in readers().items()}
    line = {"correct": all(c.ok for c in outcome.checks),
            "metrics": metrics, "spans_wall_s": s.wall_s,
            "timed_wall_s": outcome.trace.wall_s, "spans": s.spans}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
