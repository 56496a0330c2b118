"""Complex-YOLO loss: dense target assignment and the 9-term loss, on the
device, in f32.

Counterpart of `complex_yolov4_tpu/losses/yolo_loss.py` (`_bce`,
`build_targets_dense`, `head_loss`, `network_loss`; reference:
src/models/yolo_layer.py:69-251):

- per head, each valid target is matched to the best anchor by rotated IoU
  at a fixed centre; the matched (batch, row, col, anchor) cell gets obj=1
  and the regression targets tx/ty, tw/th (log size ratios), tim/tre and a
  one-hot class; noobj is cleared at matched cells and wherever a target's
  anchor IoU exceeds `ignore_thresh`;
- MSE mode: loss = mse(x)+mse(y)+mse(w)+mse(h)+eular+obj_bce+100*noobj_bce
  +cls_bce; GIoU mode: 3.54*giou + 3.54*eular + 64.3*(obj_bce+noobj_bce)
  + 37.4*cls_bce, with the rotated GIoU of `ops.rotated_boxes`.

Duplicate targets on one cell: the last target wins, as in the original.
The winner of each cell is the largest `target index + 1` landing on it,
found by `scatter_reduce(..., "amax")`; the per-cell targets are then
gathered from the winner's row. No `index_put_` writes the cell grid, whose
winner on CUDA would be undefined for duplicate indices.

Inputs: decode dicts of `models.yolo_head.decode_head_raw`, targets (B, T, 7)
[cls, x, y, w, l, im, re] normalized rows and a (B, T) validity mask.

Data parallel (`group`): every term is a sum over cells or targets divided
by a count (matched cells, valid targets, noobj cells, confident cells).
With a process group the counts are all-reduced (they carry no gradient),
so each rank's loss and metrics are its own sums over the global counts:
their sum over the ranks is the loss and the metrics of the global batch,
as the JAX step on a data mesh computes them. The train step scales the
rank's loss by the world size before the backward, so that DDP's mean of
the gradients is the gradient of that sum.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.spec import NetSpec, YoloSpec
from ..ops import rotated_boxes as rb

# Loss scale constants (reference: yolo_layer.py:40-45).
NOOBJ_SCALE = 100.0
OBJ_SCALE = 1.0
LGIOU_SCALE = 3.54
LEULAR_SCALE = 3.54
LOBJ_SCALE = 64.3
LCLS_SCALE = 37.4

_EPS = 1e-16


def _clamped_logs(p: torch.Tensor):
    logp = torch.clamp(torch.log(torch.clamp(p, min=0.0)), min=-100.0)
    logq = torch.clamp(torch.log(torch.clamp(1.0 - p, min=0.0)), min=-100.0)
    return logp, logq


class _BCE(torch.autograd.Function):
    """Elementwise binary cross entropy with torch's numerics (value with a
    -100 log clamp) and a bounded gradient (p - t) / max(p (1 - p), 1e-12):
    once a sigmoid saturates to exactly 0 or 1 in f32 the plain -1/(1-p)
    gradient overflows and NaNs the model."""

    @staticmethod
    def forward(ctx, p, t):
        ctx.save_for_backward(p, t)
        logp, logq = _clamped_logs(p)
        return -(t * logp + (1.0 - t) * logq)

    @staticmethod
    def backward(ctx, g):
        p, t = ctx.saved_tensors
        denom = torch.clamp(p * (1.0 - p), min=1e-12)
        gp = g * (p - t) / denom if ctx.needs_input_grad[0] else None
        gt = None
        if ctx.needs_input_grad[1]:
            logp, logq = _clamped_logs(p)
            gt = g * (logq - logp)
        return gp, gt


def bce(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return _BCE.apply(p, t)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """sum(x * mask) / max(count, 1); count: mask's sum (over every rank's
    batch under a process group)."""
    return (x * mask).sum() / torch.clamp(count, min=1.0)


def _gather_cells(values: torch.Tensor, src: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """Per-cell values of each cell's winning target: values (B*T, ...) rows
    gathered at src (n_cells,), zero where the cell has none."""
    out = values[src]
    mask = has.reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(mask, out, torch.zeros_like(out))


def build_targets_dense(g: int, anchors: torch.Tensor, nc: int, targets: torch.Tensor,
                        target_mask: torch.Tensor, ignore_thresh: float) -> Dict[str, torch.Tensor]:
    """Dense target assignment for one head (yolo_layer.py:69-133).

    g: grid size; anchors: (A, 4) grid-unit (w, h, im, re); targets (B, T,
    7), target_mask (B, T). Returns flat (B*G*G*A[, C]) grids obj, noobj,
    tx, ty, tw, th, tim, tre, tcls, and per target: cell (B, T) linear cell
    ids (n_cells for invalid targets), is_winner, valid, t5 (B, T, 5) grid
    boxes and tcls_id; plus `winner` (n_cells,), the flat index b*T + t of
    each cell's winning target (-1: none)."""
    dev = targets.device
    na = anchors.shape[0]
    b_sz, t_cap = targets.shape[0], targets.shape[1]
    targets = targets.float()
    valid = target_mask > 0.5
    t_cls = targets[..., 0].long()
    gx, gy = targets[..., 1] * g, targets[..., 2] * g
    gw, gh = targets[..., 3] * g, targets[..., 4] * g
    gim, gre = targets[..., 5], targets[..., 6]

    # anchor matching: rotated IoU at a fixed centre (yolo_layer.py:105-107)
    t_yaw = torch.atan2(gim, gre)
    a_yaw = torch.atan2(anchors[:, 2], anchors[:, 3])
    zt = torch.zeros_like(gw)
    t_fixed = torch.stack([zt, zt, gw, gh, t_yaw], dim=-1)
    za = torch.zeros(na, device=dev)
    a_boxes = torch.stack([za, za, anchors[:, 0], anchors[:, 1], a_yaw], dim=-1)
    anchor_ious = rb.rotated_iou(t_fixed[:, :, None, :].expand(b_sz, t_cap, na, 5),
                                 a_boxes[None, None].expand(b_sz, t_cap, na, 5))
    best_n = torch.argmax(anchor_ious, dim=-1)

    gi = torch.clamp(torch.floor(gx), 0, g - 1).long()
    gj = torch.clamp(torch.floor(gy), 0, g - 1).long()
    n_cells = b_sz * g * g * na
    b_idx = torch.arange(b_sz, device=dev)[:, None].expand(b_sz, t_cap)
    cell = ((b_idx * g + gj) * g + gi) * na + best_n
    cell = torch.where(valid, cell, torch.full_like(cell, n_cells))

    # last target wins: each cell's winner is the largest t + 1 landing on it
    t_idx = torch.arange(t_cap, device=dev)[None, :].expand(b_sz, t_cap)
    order = torch.where(valid, t_idx + 1, torch.zeros_like(t_idx))
    winner_of_cell = torch.zeros(n_cells + 1, dtype=torch.long, device=dev).scatter_reduce(
        0, cell.reshape(-1), order.reshape(-1), "amax")
    is_winner = valid & (winner_of_cell[cell] == t_idx + 1)
    has = winner_of_cell[:n_cells] > 0
    cell_b = torch.arange(n_cells, device=dev) // (g * g * na)
    winner = torch.where(has, cell_b * t_cap + winner_of_cell[:n_cells] - 1,
                         torch.full_like(cell_b, -1))
    src = torch.clamp(winner, min=0)

    def gather(values: torch.Tensor) -> torch.Tensor:
        return _gather_cells(values.reshape((b_sz * t_cap,) + values.shape[2:]), src, has)

    obj_flat = has.float()
    cls_safe = torch.clamp(t_cls, 0, nc - 1)
    tcls = torch.nn.functional.one_hot(cls_safe, nc).float()

    # noobj: 1 except at matched cells and ignore_thresh exceedances across
    # all anchors of the target's cell (yolo_layer.py:114-119)
    cell_all_a = (((b_idx * g + gj) * g + gi)[..., None] * na
                  + torch.arange(na, device=dev)[None, None, :])
    ignore = valid[..., None] & (anchor_ious > ignore_thresh)
    mark = torch.zeros(n_cells + 1, device=dev).scatter_reduce(
        0, torch.where(ignore, cell_all_a, torch.full_like(cell_all_a, n_cells)).reshape(-1),
        torch.ones(b_sz * t_cap * na, device=dev), "amax")[:n_cells]
    noobj_flat = 1.0 - torch.maximum(obj_flat, mark)

    eps = torch.tensor(_EPS, device=dev)
    return {
        "obj": obj_flat, "noobj": noobj_flat,
        "tx": gather(gx - torch.floor(gx)), "ty": gather(gy - torch.floor(gy)),
        "tw": gather(torch.log(gw / anchors[best_n, 0] + eps)),
        "th": gather(torch.log(gh / anchors[best_n, 1] + eps)),
        "tim": gather(gim), "tre": gather(gre), "tcls": gather(tcls),
        "cell": cell, "is_winner": is_winner, "valid": valid,
        "t5": torch.stack([gx, gy, gw, gh, t_yaw], dim=-1),
        "tcls_id": cls_safe, "winner": winner,
    }


def head_loss(raw: Dict, spec: YoloSpec, targets: torch.Tensor, target_mask: torch.Tensor, *,
              use_giou_loss: bool = False, want_metrics: bool = True, group=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss for one YOLO head; returns (total, the 18-metric dict).

    want_metrics=False skips the metric-only work (the pred-vs-target IoU
    in MSE mode, the per-cell score gathers) and reports those 8 metrics as
    0, as the original's `lax.cond` branch does. group: the process group
    over which the counts are all-reduced (module docstring)."""
    g = raw["grid_size"]
    anchors = raw["scaled_anchors"]
    na = anchors.shape[0]
    b_sz, t_cap = targets.shape[0], targets.shape[1]
    nc = raw["pred_cls"].shape[-1]
    dev = targets.device
    dense = build_targets_dense(g, anchors, nc, targets, target_mask, spec.ignore_thresh)
    obj_flat, noobj_flat = dense["obj"], dense["noobj"]
    cell, valid, t5, cls_safe = dense["cell"], dense["valid"], dense["t5"], dense["tcls_id"]
    n_cells = b_sz * g * g * na

    def flat(x):
        return x.reshape((n_cells,) + x.shape[4:])

    pred_x, pred_y = flat(raw["pred_x"]), flat(raw["pred_y"])
    pred_w, pred_h = flat(raw["pred_w"]), flat(raw["pred_h"])
    pred_im, pred_re = flat(raw["pred_im"]), flat(raw["pred_re"])
    pred_conf, pred_cls = flat(raw["pred_conf"]), flat(raw["pred_cls"])
    pred_boxes = flat(raw["pred_boxes"])

    conf50 = (pred_conf.detach() > 0.5).float()
    counts = torch.stack([obj_flat.sum(), valid.sum().float(), noobj_flat.sum(), conf50.sum()])
    if group is not None:
        dist.all_reduce(counts, group=group)
    n_obj, n_valid, n_noobj, n_conf50 = counts.unbind()
    one = torch.ones((), device=dev)

    def obj_mse(p, t):
        return ((p - t) ** 2 * obj_flat).sum() / torch.maximum(n_obj, one)

    loss_x = obj_mse(pred_x, dense["tx"])
    loss_y = obj_mse(pred_y, dense["ty"])
    loss_w = obj_mse(pred_w, dense["tw"])
    loss_h = obj_mse(pred_h, dense["th"])
    loss_im = obj_mse(pred_im, dense["tim"])
    loss_re = obj_mse(pred_re, dense["tre"])
    # the eps guards sqrt'(0) where a cell predicts im = re = 0 exactly
    circle = (1.0 - torch.sqrt(pred_im ** 2 + pred_re ** 2 + 1e-12)) ** 2
    loss_im_re = _masked_mean(circle, obj_flat, n_obj)
    loss_eular = loss_im + loss_re + loss_im_re

    bce_conf = bce(pred_conf, obj_flat)
    loss_conf_obj = _masked_mean(bce_conf, obj_flat, n_obj)
    loss_conf_noobj = _masked_mean(bce_conf, noobj_flat, n_noobj)
    loss_cls = ((bce(pred_cls, dense["tcls"]) * obj_flat[:, None]).sum()
                / torch.maximum(n_obj * nc, one))

    # per-target pred-vs-target rotated IoU / GIoU (yolo_layer.py:128-133)
    tgt_cell = torch.where(valid, cell, torch.zeros_like(cell)).reshape(-1)
    pb = pred_boxes[tgt_cell].reshape(b_sz, t_cap, 6)
    p5 = torch.stack([pb[..., 0], pb[..., 1], pb[..., 2], pb[..., 3],
                      torch.atan2(pb[..., 4], pb[..., 5])], dim=-1)
    vmask = valid.float()
    zero = torch.zeros((), device=dev)
    if use_giou_loss:
        giou, iou_for_loss = rb.rotated_giou(p5, t5)
        giou_loss = ((1.0 - giou) * vmask).sum() / torch.maximum(n_valid, one)
        loss_obj = loss_conf_obj + loss_conf_noobj
        total = (giou_loss * LGIOU_SCALE + loss_eular * LEULAR_SCALE
                 + loss_obj * LOBJ_SCALE + loss_cls * LCLS_SCALE)
    else:
        iou_for_loss = None
        giou_loss = zero
        loss_obj = OBJ_SCALE * loss_conf_obj + NOOBJ_SCALE * loss_conf_noobj
        total = loss_x + loss_y + loss_w + loss_h + loss_eular + loss_obj + loss_cls

    if want_metrics:  # metrics (parity with yolo_layer.py:223-251)
        with torch.no_grad():
            iou = rb.rotated_iou(p5, t5) if iou_for_loss is None else iou_for_loss
            iou_loss_plain = ((1.0 - iou) * vmask).sum() / torch.maximum(n_valid, one)
            winner, has = dense["winner"], dense["winner"] >= 0
            src = torch.clamp(winner, min=0)
            cls_pred_at = torch.argmax(pred_cls, dim=-1)
            match = ((cls_pred_at[tgt_cell].reshape(b_sz, t_cap) == cls_safe).float() * vmask)
            class_match = _gather_cells(match.reshape(-1), src, has)
            iou_scores = _gather_cells((iou * vmask).reshape(-1), src, has)
            iou50 = (iou_scores > 0.5).float()
            iou75 = (iou_scores > 0.75).float()
            detected = conf50 * class_match * obj_flat
            eps = torch.tensor(_EPS, device=dev)
            extras = (
                _masked_mean(iou_scores, obj_flat, n_obj),
                giou_loss.detach() if use_giou_loss else iou_loss_plain,
                100.0 * _masked_mean(class_match, obj_flat, n_obj),
                (iou50 * detected).sum() / torch.maximum(n_obj, eps),
                (iou75 * detected).sum() / torch.maximum(n_obj, eps),
                (iou50 * detected).sum() / (n_conf50 + eps),
                _masked_mean(pred_conf, obj_flat, n_obj),
                _masked_mean(pred_conf, noobj_flat, n_noobj),
            )
    else:
        extras = (zero,) * 8
    (iou_score, giou_metric, cls_acc, recall50, recall75, precision,
     conf_obj, conf_noobj) = extras
    metrics = {
        "loss": total, "iou_score": iou_score, "giou_loss": giou_metric,
        "loss_x": loss_x, "loss_y": loss_y, "loss_w": loss_w, "loss_h": loss_h,
        "loss_eular": loss_eular, "loss_im": loss_im, "loss_re": loss_re,
        "loss_obj": loss_obj, "loss_cls": loss_cls, "cls_acc": cls_acc,
        "recall50": recall50, "recall75": recall75, "precision": precision,
        "conf_obj": conf_obj, "conf_noobj": conf_noobj,
    }
    return total, metrics


def network_loss(spec: NetSpec, head_raw: Sequence[Dict], targets: torch.Tensor,
                 target_mask: torch.Tensor, *, use_giou_loss: bool = False,
                 want_metrics: bool = True, group=None
                 ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Sum of the per-head losses (reference: darknet2pytorch.py:220-226);
    returns (total, per-head metric dicts). With a process group, the
    rank's share of them (module docstring)."""
    yolo_specs = [spec.layers[i] for i in spec.yolo_indices]
    if len(yolo_specs) != len(head_raw):
        raise ValueError(f"{len(head_raw)} heads for {len(yolo_specs)} yolo layers")
    total = torch.zeros((), device=targets.device)
    all_metrics = []
    for hspec, raw in zip(yolo_specs, head_raw):
        loss, metrics = head_loss(raw, hspec, targets, target_mask,
                                  use_giou_loss=use_giou_loss, want_metrics=want_metrics,
                                  group=group)
        total = total + loss
        all_metrics.append(metrics)
    return total, all_metrics
