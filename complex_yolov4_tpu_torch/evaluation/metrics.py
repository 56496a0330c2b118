"""Detection metrics: rotated-IoU TP matching and per-class AP.

Counterpart of `complex_yolov4_tpu/evaluation/metrics.py` (reference:
src/utils/evaluation_utils.py:70-190): predictions are matched greedily in
score order against unmatched ground truths at rotated IoU >= threshold,
and AP is the area under the precision-envelope PR curve (py-faster-rcnn
style). The (K, T) IoU matrix of a sample comes from the port's torch
`pairwise_rotated_iou`, on the device the detections lie on (the CPU for
numpy detections); the greedy bookkeeping is numpy.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops import rotated_boxes as rb


def _boxes6_to_5(boxes6: torch.Tensor) -> torch.Tensor:
    """(N, 6) [x, y, w, l, im, re] -> (N, 5) [x, y, w, l, yaw] f32, on
    boxes6's device."""
    boxes6 = boxes6.float()
    return torch.cat([boxes6[:, :4], torch.atan2(boxes6[:, 4:5], boxes6[:, 5:6])], 1)


def rescale_boxes(boxes: np.ndarray, current_dim: int, original_shape) -> np.ndarray:
    """Undo letterbox padding/scaling of axis-aligned boxes
    (reference: evaluation_utils.py:52-68). BEV rasters are square, so this
    is the identity there; kept for protocol parity with non-square inputs."""
    orig_h, orig_w = original_shape
    pad_x = max(orig_h - orig_w, 0) * (current_dim / max(original_shape))
    pad_y = max(orig_w - orig_h, 0) * (current_dim / max(original_shape))
    unpad_h = current_dim - pad_y
    unpad_w = current_dim - pad_x
    out = np.asarray(boxes, np.float64).copy()
    out[:, 0] = ((out[:, 0] - pad_x // 2) / unpad_w) * orig_w
    out[:, 1] = ((out[:, 1] - pad_y // 2) / unpad_h) * orig_h
    out[:, 2] = ((out[:, 2] - pad_x // 2) / unpad_w) * orig_w
    out[:, 3] = ((out[:, 3] - pad_y // 2) / unpad_h) * orig_h
    return out


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sample_statistics(detections, det_mask, targets, target_mask,
                      iou_threshold: float, img_size: float,
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TP flags for one sample (reference: evaluation_utils.py:152-190).

    Args:
      detections: (K, 9) NMS rows [x..re, conf, cls_conf, cls_id] in pixels,
        score-ordered (numpy or a tensor); det_mask: (K,) live flags.
      targets: (T, 7) normalized [cls, x, y, w, l, im, re]; target_mask: (T,).

    Returns (true_positives, pred_scores, pred_labels) over live detections.
    """
    det_t = torch.as_tensor(detections)
    det_mask = _numpy(det_mask)
    targets, target_mask = _numpy(targets), _numpy(target_mask)
    live = det_mask > 0.5
    dets = _numpy(det_t)[live]
    n_pred = dets.shape[0]
    tp = np.zeros(n_pred, np.float64)
    scores = dets[:, 6].astype(np.float64)
    labels = dets[:, 8].astype(np.float64)
    tlive = target_mask > 0.5
    tgt = targets[tlive]
    if n_pred == 0 or tgt.shape[0] == 0:
        return tp, scores, labels

    tgt_boxes6 = targets[:, 1:7].copy()
    tgt_boxes6[:, :4] *= img_size
    iou_full = rb.pairwise_rotated_iou(
        _boxes6_to_5(det_t[:, :6]),
        _boxes6_to_5(torch.from_numpy(tgt_boxes6).to(det_t.device))).cpu().numpy()
    iou_mat = iou_full[live][:, tlive]
    target_labels = tgt[:, 0]
    detected: List[int] = []
    for i in range(n_pred):
        if len(detected) == tgt.shape[0]:
            break
        if labels[i] not in target_labels:
            continue
        j = int(np.argmax(iou_mat[i]))
        if iou_mat[i, j] >= iou_threshold and j not in detected:
            tp[i] = 1.0
            detected.append(j)
    return tp, scores, labels


def batch_statistics(detections, det_masks, targets, target_masks,
                     iou_threshold: float, img_size: float,
                     ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-sample statistics over a batch of NMS outputs."""
    return [
        sample_statistics(detections[i], det_masks[i], targets[i],
                          target_masks[i], iou_threshold, img_size)
        for i in range(detections.shape[0])
    ]


def ap_per_class(
    tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-class precision / recall / AP / F1
    (reference: evaluation_utils.py:70-122)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes = np.unique(target_cls)

    ap, p, r = [], [], []
    for c in unique_classes:
        i = pred_cls == c
        n_gt = int((target_cls == c).sum())
        n_p = int(i.sum())
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            ap.append(0.0)
            r.append(0.0)
            p.append(0.0)
            continue
        fpc = (1 - tp[i]).cumsum()
        tpc = tp[i].cumsum()
        recall_curve = tpc / (n_gt + 1e-16)
        precision_curve = tpc / (tpc + fpc)
        r.append(recall_curve[-1])
        p.append(precision_curve[-1])
        ap.append(compute_ap(recall_curve, precision_curve))

    p, r, ap = np.array(p), np.array(r), np.array(ap)
    f1 = 2 * p * r / (p + r + 1e-16)
    return p, r, ap, f1, unique_classes.astype("int32")


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Precision-envelope area under the PR curve
    (reference: evaluation_utils.py:125-149)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def summarize_map(
    stats: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    labels_per_sample: Sequence[np.ndarray],
) -> Dict[str, np.ndarray]:
    """Aggregate per-sample statistics into the final metric dict."""
    if stats:
        tp = np.concatenate([s[0] for s in stats])
        conf = np.concatenate([s[1] for s in stats])
        pred_cls = np.concatenate([s[2] for s in stats])
    else:
        tp = conf = pred_cls = np.zeros((0,))
    target_cls = (
        np.concatenate(labels_per_sample) if len(labels_per_sample) else np.zeros((0,))
    )
    precision, recall, ap, f1, ap_class = ap_per_class(tp, conf, pred_cls, target_cls)
    return {
        "precision": precision,
        "recall": recall,
        "AP": ap,
        "f1": f1,
        "ap_class": ap_class,
        "mAP": ap.mean() if ap.size else np.float64(0.0),
    }
