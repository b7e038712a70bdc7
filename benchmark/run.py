"""One run of one cell of the benchmark of the PyTorch and CUDA port.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port (`bdm_tpu_torch/`). It
builds the cell from the seed, warms up every shape its traffic uses
(set-up), measures for `--seconds` (to the end of the step or slice that
passes it), takes a traced stretch with `--trace 1`, then holds what the
timed path produced against the plain reference under
`benchmark/reference/`. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` a `breakdown`, and last `checks`, each number compared
with its limit; the checks are also the last lines of standard error.

Without a CUDA device, or with fewer than the cell asks for, or with JAX
or the JAX package loaded when the window has closed, it prints no result
and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness, manifest  # noqa: E402

EXIT_NO_DEVICE = 3
EXIT_FORBIDDEN = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="also read the control (the reference at fp8 in the "
                        "program's place) on the same inputs; for setting "
                        "limits, never in the benchmark's own runs")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.load(args.workload)
    harness.cache_dirs(cell.root)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return EXIT_NO_DEVICE
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    outcome = cell.driver().run(cell, args.seed, args.seconds,
                                bool(args.trace), bool(args.control), dev,
                                T0)
    forbidden = harness.forbidden_modules()
    if forbidden:
        log(f"modules that may not be loaded here: {forbidden}")
        return EXIT_FORBIDDEN
    if args.trace:
        metrics = {}
        for m, read in cell.readers().items():
            value = read(outcome)
            if value is not None:
                metrics[m] = {"value": value, "unit": next(
                    x["unit"] for x in cell.per_layer() if x["name"] == m)}
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end()}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    if args.trace:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.wall_s
    line = harness.result(outcome, metrics, device, bool(args.trace))
    for c in outcome.checks:
        log(f"check {c.name}: {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
