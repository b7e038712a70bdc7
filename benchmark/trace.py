"""The traced stretches: `torch.profiler` over a few steps, between two
synchronisations, reduced to what the per-layer readers need. One
stretch records the device and the CUDA runtime's calls only, and gives
every number; a second records the host's operations as well, which
slows the host, and only names what the host did in the device's idle
gaps (`combine`).

The trace is written to a file under the temporary directory, read back
and deleted: kernel and copy intervals on the device, the host's launch
calls (the CUDA runtime's kernel and graph launches), and the host
operation that issued the launch ending each idle gap on the device.
Kernels are the port's own when their name is a `__global__` function of
`bdm_tpu_torch/csrc/`.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import torch

LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
            "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch"}
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|"
                     r"\([^()]*\))*\)\s*)?(\w+)\s*\(")
TOP = 10


def own_kernels(root: Path) -> set:
    """The names of the kernels the port builds from its own sources."""
    names = set()
    for p in sorted((root / "bdm_tpu_torch" / "csrc").glob("*.cu*")):
        names |= set(_GLOBAL.findall(p.read_text()))
    return names


def base_name(kernel: str) -> str:
    """'void (anonymous namespace)::foo_kernel<128>(float const*, ...)'
    -> 'foo_kernel'."""
    s = kernel.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    s = s.split("(")[0].split("<")[0]
    return s.rsplit("::", 1)[-1].strip()


@dataclass
class Summary:
    """What one traced stretch showed."""
    steps: int
    wall_s: float
    busy_s: float
    launches: int
    own_s: float
    other_s: float
    own_by_kernel: Dict[str, List[float]] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


class Stretch:
    """Profile the work between `start()` and `stop()`; each waits for the
    device, so the stretch holds exactly the work issued inside it. With
    `host_ops` the host's operations are recorded too, which slows the
    host: such a stretch serves only to name what the host did in the
    device's idle gaps."""

    def __init__(self, host_ops: bool = False):
        self.host_ops = host_ops
        self.prof = None
        self.wall_s = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA]
        if self.host_ops:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Stop and write the trace out at once: a later profiler session
        in the process clears this one's events."""
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None

    def summary(self, steps: int, own: set) -> Summary:
        events, self.events = self.events, None
        return reduce(events, steps, self.wall_s, own)


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _host_op(ops_by_tid, tid, ts) -> str:
    """The innermost host operation on thread `tid` running at `ts`."""
    starts, ops = ops_by_tid.get(tid, ([], []))
    k = bisect.bisect_right(starts, ts) - 1
    best = None
    for j in range(k, max(-1, k - 64), -1):
        s, e, name = ops[j]
        if s <= ts <= e and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "no host op"


def reduce(events: List[dict], steps: int, wall_s: float,
           own: set) -> Summary:
    dev, runtime, cpu = [], {}, collections.defaultdict(list)
    launches = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if e.get("name") in LAUNCHES:
                launches += 1
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                runtime[corr] = e
        elif cat == "cpu_op":
            cpu[e.get("tid")].append((float(e["ts"]),
                                      float(e["ts"]) + float(e["dur"]),
                                      e["name"]))
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    ops_by_tid = {}
    for tid, ops in cpu.items():
        ops.sort()
        ops_by_tid[tid] = ([o[0] for o in ops], ops)
    by_name = collections.defaultdict(float)
    own_by = collections.defaultdict(lambda: [0.0, 0])
    own_s = other_s = 0.0
    for e in dev:
        dur = float(e["dur"]) * 1e-6
        if e["cat"] != "kernel":
            by_name[e["name"][:96]] += dur
            continue
        base = base_name(e["name"])
        if base in own:
            own_s += dur
            own_by[base][0] += dur
            own_by[base][1] += 1
            by_name[base] += dur
        else:
            other_s += dur
            by_name[e["name"][:96]] += dur
    busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in dev) * 1e-6
    gaps = collections.defaultdict(float)
    order = sorted(dev, key=lambda e: float(e["ts"]))
    end = float(order[0]["ts"]) + float(order[0]["dur"])
    for e in order[1:]:
        ts = float(e["ts"])
        if ts > end:
            r = runtime.get(e.get("args", {}).get("correlation"))
            label = (_host_op(ops_by_tid, r.get("tid"), float(r["ts"]))
                     if r is not None else "no launch found")
            gaps[label] += (ts - end) * 1e-6
        end = max(end, ts + float(e["dur"]))

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return Summary(steps, wall_s, busy, launches, own_s, other_s,
                   {k: v for k, v in own_by.items()}, top(by_name),
                   top(gaps))



def combine(timed: Summary, named: Summary) -> Summary:
    """The numbers of the stretch without host operations, with the idle
    gaps as the stretch with them named and measured them."""
    timed.idle_gaps = named.idle_gaps
    return timed
