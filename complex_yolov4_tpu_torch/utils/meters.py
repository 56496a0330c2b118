"""Progress meters (reference: src/utils/misc.py:11-56) and step timing
that waits for the device.

`AverageMeter` and `ProgressMeter` are copies of
`complex_yolov4_tpu/utils/meters.py`'s (held equal by
`tests/test_torch_port_copies.py`); `time_synchronized` waits for the
CUDA device (`torch.cuda.synchronize`) where the original blocks on JAX
arrays.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import torch


class AverageMeter:
    """Running average of a scalar (reference: misc.py:11-33)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self) -> str:
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    """Batch progress line printer (reference: misc.py:36-55)."""

    def __init__(self, num_batches: int, meters: Iterable[AverageMeter], prefix: str = ""):
        self.batch_fmtstr = self._fmt(num_batches)
        self.meters = list(meters)
        self.prefix = prefix

    def get_message(self, batch: int) -> str:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        return "\t".join(entries)

    @staticmethod
    def _fmt(num_batches: int) -> str:
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"


def time_synchronized(device: Optional[torch.device] = None) -> float:
    """Wall clock after the CUDA device has finished its queued work
    (reference: misc.py:58-60); the plain clock on the CPU."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)
    return time.time()
