"""Metric meters (port of the JAX package's `utils/metrics.py`: SmoothedValue,
MetricLogger, per_class_precision_recall). At a world of several processes
`synchronize_between_processes` sums each meter's count and total over the
ranks (the step's device metrics are already the global batch's)."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque

import numpy as np

from ..parallel.dist import all_reduce_host


class SmoothedValue:
    """A window of recent values plus the global total and count."""

    def __init__(self, window_size: int = 20, fmt: str | None = None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """[count, total] summed over the ranks (float64); the window stays
        this rank's."""
        count, total = all_reduce_host(np.array([self.count, self.total], np.float64))
        self.count, self.total = int(count), float(total)

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


class MetricLogger:
    """A dict of meters with attribute access and a timed iterator."""

    def __init__(self, delimiter: str = "\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            if hasattr(v, "item"):
                v = v.item()
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        if attr in self.__dict__:
            return self.__dict__[attr]
        raise AttributeError(f"'MetricLogger' object has no attribute '{attr}'")

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def log_every(self, iterable, print_freq, header=None):
        """Yield from `iterable`, printing progress, ETA and the meters every
        `print_freq` items (never when it is 0), and the total time at the end."""
        i = 0
        header = header or ""
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        total = len(iterable) if hasattr(iterable, "__len__") else None
        space_fmt = ":" + str(len(str(total))) + "d" if total else ""
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and (i % print_freq == 0 or (total and i == total - 1)):
                if total:
                    eta = str(datetime.timedelta(seconds=int(iter_time.global_avg * (total - i))))
                    msg = self.delimiter.join([
                        header, ("[{0" + space_fmt + "}/{1}]").format(i, total),
                        f"eta: {eta}", str(self), f"time: {iter_time}", f"data: {data_time}"])
                else:
                    msg = self.delimiter.join([header, f"[{i}]", str(self)])
                print(msg)
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        if total:
            print("{} Total time: {} ({:.4f} s / it)".format(
                header, str(datetime.timedelta(seconds=int(total_time))), total_time / total))


def per_class_precision_recall(tp, fp, fn):
    """Elementwise precision/recall with zero-denominator guards."""
    precision = [
        float(t) / (t + f) if t + f > 0 else 0.0 for t, f in zip(tp, fp)
    ]
    recall = [
        float(t) / (t + f) if t + f > 0 else 0.0 for t, f in zip(tp, fn)
    ]
    return precision, recall
