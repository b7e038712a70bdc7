"""Host-side metric logging (`bdm_tpu/train/metrics.py`; the port keeps
its own copy, pure Python).

`MetricLogger` / `SmoothedValue` of the reference
(`training_utils.py:112-254`): windowed smoothing, step timing and
periodic printing.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Dict, Iterable, Optional


class SmoothedValue:
    """Track a series over a sliding window + global average."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f}"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(1, len(self.deque))

    @property
    def global_avg(self) -> float:
        return self.total / max(1, self.count)

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg)


class MetricLogger:
    def __init__(self, delimiter: str = "  ",
                 jsonl_path: Optional[str] = None):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter
        self.jsonl_path = jsonl_path

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_jsonl(self, step: int, **extra):
        if self.jsonl_path is None:
            return
        rec = {"step": step,
               **{k: m.median for k, m in self.meters.items()}, **extra}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
        """Yield items, tracking data/iter time like the reference
        (`training_utils.py:210-254`)."""
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0:
                print(f"{header} [{i}] {self}  time: {iter_time}  "
                      f"data: {data_time}")
