"""Faults planted in the timed path, to show that the correctness check
sees them: used by `limits.py --fault` (readings on the card) and by
`tests/test_port_bench_faults.py`, never by a benchmark run.

Each fault patches the port in this process through `patch(obj, name,
value)` (pytest's `monkeypatch.setattr`, or `Patches`, which undoes its
patches on `undo()`).

`answer_altered` alters one frame's answer where the NMS produces it: each
detection of the first frame of a request names the class that the
program itself ranks last at that box. `half_batch` runs the network on
the first half of the batch and hands its heads on for the rest too."""

from __future__ import annotations

import torch


class Patches:
    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


def answer_altered(patch):
    from complex_yolov4_tpu_torch.evaluation import evaluator

    real = evaluator.nms_batch

    def altered(decoded, *args, **kw):
        dets, masks = real(decoded, *args, **kw)
        d, rows = decoded[0].float(), dets[0].float()
        # each row's box: the decoded box with its conf and class conf
        key = ((d[None, :, 6] - rows[:, None, 6]).abs()
               + (d[None, :, 7:].amax(-1) - rows[:, None, 7]).abs())
        least = d[key.argmin(1), 7:].argmin(-1).to(dets.dtype)
        dets = dets.clone()
        dets[0, :, 8] = torch.where(masks[0] > 0.5, least, dets[0, :, 8])
        return dets, masks

    patch(evaluator, "nms_batch", altered)


def half_batch(patch):
    from complex_yolov4_tpu_torch.models.network import Darknet

    real = Darknet.forward

    def half(self, x, **kw):
        if kw.get("stop_after") is not None or kw.get("capture") is not None:
            return real(self, x, **kw)
        out = real(self, x[: x.shape[0] // 2], **kw)
        return torch.cat([out, out], dim=0)

    patch(Darknet, "forward", half)


SERVING = {"answer_altered": answer_altered, "half_batch": half_batch}
