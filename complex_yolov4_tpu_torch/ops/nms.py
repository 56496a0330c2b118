"""Rotated NMS with confidence-weighted box merging.

Counterpart of `complex_yolov4_tpu/ops/nms.py` (`_candidates`,
`_suppress_matrix`, `nms_batch`); behavioural contract of the reference's
`post_processing_v2` (src/utils/evaluation_utils.py:321-357):

1. keep predictions with objectness >= conf_thresh;
2. order by objectness * best-class probability, top k;
3. greedy suppression: the current best suppresses same-class boxes whose
   rotated IoU (against the *unmerged* best box) exceeds nms_thresh, and
   its kept coordinates become the objectness-weighted average of the
   suppressed group's coordinates;
4. rows [x, y, w, l, im, re, conf, cls_conf, cls_id].

The pairwise IoU runs on the upper-triangle pair list, and the greedy keep
set is the same exact fixpoint as the JAX package's: box i is kept iff no
higher-ranked kept box suppresses it, so statuses resolve in rounds, until
every candidate is decided or after k rounds, as the JAX package's
`lax.while_loop` runs them. One loop body serves two drivers: under
`torch.export` the rounds run in one `while_loop` (the higher-order op of
`torch._higher_order_ops`), one node of the graph, so an exported program
keeps the early exit; eagerly a Python `while` runs the same condition and
body with one host read a round, which dispatches faster than the
higher-order op's eager form. JAX applies 8 rounds an iteration (a TPU
loop iteration is dear); here an iteration applies one, since a serving
request mostly resolves in one round and an idle round costs a dozen
kernel launches. A flat `torch.topk` and a plain index gather replace the
TPU's hierarchical top-k and one-hot matmul gather. Score ties may order
differently from the JAX package's top-k; ties carry no semantics.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch._higher_order_ops.while_loop import while_loop_op

from ..utils import tracing
from . import rotated_boxes as rb

_NEG = -1e9


def _candidates(decoded: torch.Tensor, conf_thresh: float, k: int):
    """(B, N, 7+C) -> top-k score-ordered candidates (B, k, 9) + validity."""
    conf = decoded[..., 6]
    cls_conf, cls_id = decoded[..., 7:].max(dim=-1)
    score = torch.where(conf >= conf_thresh, conf * cls_conf,
                        torch.full_like(conf, _NEG))
    top_score, top_idx = torch.topk(score, k, dim=-1)
    cols = torch.cat([decoded[..., :6], conf[..., None], cls_conf[..., None],
                      cls_id[..., None].to(decoded.dtype)], dim=-1)  # (B, N, 9)
    cand = torch.gather(cols, 1, top_idx[..., None].expand(-1, -1, 9))
    return cand, top_score > _NEG / 2


def _suppress_matrix(cand: torch.Tensor, nms_thresh: float) -> torch.Tensor:
    """(B, k, 9) -> (B, k, k) same-class IoU-over-threshold matrix from the
    original boxes, via the upper-triangle pair list (includes self)."""
    b, k = cand.shape[:2]
    b5 = torch.stack([cand[..., 0], cand[..., 1], cand[..., 2], cand[..., 3],
                      torch.atan2(cand[..., 4], cand[..., 5])], dim=-1)
    ii, jj = torch.triu_indices(k, k, 1, device=cand.device)
    iou_pairs = rb.rotated_iou(b5[:, ii], b5[:, jj])  # (B, k(k-1)/2)
    upper = torch.zeros((b, k, k), dtype=cand.dtype, device=cand.device)
    upper[:, ii, jj] = iou_pairs
    iou = upper + upper.transpose(1, 2) + torch.eye(k, dtype=cand.dtype, device=cand.device)
    same_cls = cand[..., 8][:, :, None] == cand[..., 8][:, None, :]
    return (iou > nms_thresh) & same_cls


def _undecided_left(keep, undecided, it, blocker):
    """The loop's condition: a candidate undecided, and fewer than k rounds
    run (never binding: k rounds decide every candidate)."""
    return undecided.any() & (it < blocker.shape[-1])


def _rounds(keep, undecided, it, blocker):
    """One fixpoint round: an undecided candidate is kept when no kept or
    undecided candidate above it blocks it, and rejected when a kept one
    does. The loop carries the undecided set itself, so that a round costs
    as few ops as the greedy rule needs."""
    live_blocker = blocker & (keep | undecided)[:, :, None]
    kept = undecided & ~live_blocker.any(dim=1)
    keep = keep | kept
    rejected = (blocker & keep[:, :, None]).any(dim=1)
    return keep, undecided & ~(kept | rejected), it + 1


def _keep_set(valid: torch.Tensor, blocker: torch.Tensor) -> torch.Tensor:
    """The exact greedy keep set (B, k) by fixpoint rounds; each round
    decides at least the highest-ranked undecided candidate, so k rounds
    always suffice. Exported, one `while_loop` whose extra input is
    `blocker` (a tensor it closed over would not export); eagerly, a Python
    loop over the same condition and body, each round counted as
    `nms.rounds` (`utils/tracing.py`)."""
    carry = (torch.zeros_like(valid), valid,
             torch.zeros((), dtype=torch.int64, device=valid.device))
    if torch.compiler.is_exporting():
        return while_loop_op(_undecided_left, _rounds, carry, (blocker,))[0]
    while bool(_undecided_left(*carry, blocker)):
        carry = _rounds(*carry, blocker)
        tracing.count("nms.rounds")
    return carry[0]


def nms_batch(decoded: torch.Tensor, conf_thresh: float = 0.95,
              nms_thresh: float = 0.4, max_boxes: int = 256
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched NMS: (B, N, 7+C) f32 -> ((B, max_boxes, 9), (B, max_boxes)).

    Detections are score-ordered; dead rows are zero; the mask is 1.0 for
    live detections."""
    b = decoded.shape[0]
    k = min(max_boxes, decoded.shape[1])
    dev = decoded.device
    cand, valid = _candidates(decoded, conf_thresh, k)
    suppress = _suppress_matrix(cand, nms_thresh)

    idx = torch.arange(k, device=dev)
    # blocker[b, j, i]: candidate j outranks i and suppresses it
    blocker = suppress & (idx[:, None] < idx[None, :])

    keep = _keep_set(valid, blocker)

    # Absorption: keeper i absorbs j iff i is the highest-ranked keeper
    # suppressing j; merged coordinates are the conf-weighted mean. The sum
    # is elementwise in true f32 (no matmul, so no TF32).
    keeper_overlap = suppress & keep[:, :, None] & valid[:, None, :]
    absorber = torch.where(keeper_overlap, idx[None, :, None],
                           torch.full_like(idx[None, :, None], k)).amin(dim=1)
    group = keeper_overlap & (absorber[:, None, :] == idx[None, :, None])
    w = torch.where(group, cand[:, None, :, 6], torch.zeros((), dtype=cand.dtype, device=dev))
    wsum = torch.clamp(w.sum(dim=2, keepdim=True), min=1e-16)
    merged_boxes = (w[..., None] * cand[:, None, :, :6]).sum(dim=2) / wsum
    kept = keep.to(decoded.dtype)
    merged = torch.cat([merged_boxes, cand[:, :, 6:9]], dim=-1)

    out = torch.zeros((b, max_boxes, 9), dtype=decoded.dtype, device=dev)
    out[:, :k] = merged * kept[:, :, None]
    mask = torch.zeros((b, max_boxes), dtype=decoded.dtype, device=dev)
    mask[:, :k] = kept
    return out, mask


def nms_single(decoded: torch.Tensor, conf_thresh: float = 0.95,
               nms_thresh: float = 0.4, max_boxes: int = 256
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS for one image: (N, 7+C) -> ((max_boxes, 9), (max_boxes,))."""
    out, mask = nms_batch(decoded[None], conf_thresh, nms_thresh, max_boxes)
    return out[0], mask[0]
