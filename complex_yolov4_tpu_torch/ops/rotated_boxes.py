"""Rotated-box IoU and GIoU for NMS, eval matching and the loss, as batched,
differentiable tensor ops.

Counterpart of `complex_yolov4_tpu/ops/rotated_boxes.py` (`box_corners`,
`_corners_xy`, `_inside_convex`, `_intersection_area_xy`, `_hull_area_xy`,
`_hull_area_8`, `intersection_area`, `rotated_iou`, `rotated_giou`,
`pairwise_rotated_iou`). The intersection of two convex quads
is the convex polygon whose vertices are (a) corners of A inside B,
(b) corners of B inside A and (c) the 16 possible edge-edge crossings: 24
masked candidates, ordered by angle around their centroid (comparison
ranks, so the order is that of the JAX package, ties included) and reduced
by the masked shoelace formula. Coordinates are kept corner-major with the
batch last, (verts, ...), as in the original.

The GIoU hull is the maximal-edge formulation of the original: a directed
edge (i, j) of the 8 corners lies on the CCW hull iff every point is
strictly left of it or collinear within it, and the shoelace sum over the
qualifying edges is twice the area, with no ordering step. Hull
membership is boolean (no gradient); the area is differentiable in the
points.

Box layout: (..., 5) = [x, y, w, l, yaw], corners counter-clockwise
(reference: src/data_process/kitti_bev_utils.py:99-119).
"""

from __future__ import annotations

import torch

_EPS = 1e-6
_BIG = 1e9


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x, y, w, l, yaw] -> (..., 4, 2) corners: front-left,
    rear-left, rear-right, front-right."""
    x, y, w, l, yaw = (boxes[..., i] for i in range(5))
    c, s = torch.cos(yaw), torch.sin(yaw)
    hw, hl = w * 0.5, l * 0.5
    sw = torch.tensor([-1.0, -1.0, 1.0, 1.0], dtype=boxes.dtype, device=boxes.device)
    sl = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=boxes.dtype, device=boxes.device)
    cx = x[..., None] + sw * hw[..., None] * c[..., None] - sl * hl[..., None] * s[..., None]
    cy = y[..., None] + sw * hw[..., None] * s[..., None] + sl * hl[..., None] * c[..., None]
    return torch.stack([cx, cy], dim=-1)


def _corners_xy(boxes: torch.Tensor):
    """(..., 5) boxes -> (cx, cy) each (4, ...) — corner-major, batch last."""
    c = box_corners(boxes)
    return torch.movedim(c[..., 0], -1, 0), torch.movedim(c[..., 1], -1, 0)


def _inside_convex(px, py, qx, qy, scale):
    """px, py: (V, ...) points; qx, qy: (4, ...) CCW quad -> (V, ...) bool:
    point inside-or-on the quad (tolerance relative to `scale`)."""
    ex = torch.roll(qx, -1, dims=0) - qx
    ey = torch.roll(qy, -1, dims=0) - qy
    rx = px[:, None] - qx[None]
    ry = py[:, None] - qy[None]
    cross = ex[None] * ry - ey[None] * rx
    return torch.all(cross >= -_EPS * scale[None, None], dim=1)


def _intersection_area_xy(ax, ay, bx, by):
    """Intersection area of CCW quad pairs. ax..by: (4, ...); returns (...)."""
    scale = (ax.abs().amax(0) + ay.abs().amax(0)
             + bx.abs().amax(0) + by.abs().amax(0) + 1.0)
    a_in_b = _inside_convex(ax, ay, bx, by, scale)
    b_in_a = _inside_convex(bx, by, ax, ay, scale)

    # edge-edge crossings: A edge i (P1->P2) x B edge j (P3->P4)
    d1x = (torch.roll(ax, -1, dims=0) - ax)[:, None]
    d1y = (torch.roll(ay, -1, dims=0) - ay)[:, None]
    d2x = (torch.roll(bx, -1, dims=0) - bx)[None]
    d2y = (torch.roll(by, -1, dims=0) - by)[None]
    p13x = bx[None] - ax[:, None]
    p13y = by[None] - ay[:, None]
    denom = d1x * d2y - d1y * d2x
    denom_safe = torch.where(denom.abs() < _EPS, torch.full_like(denom, _EPS), denom)
    t = (p13x * d2y - p13y * d2x) / denom_safe
    u = (p13x * d1y - p13y * d1x) / denom_safe
    seg_valid = ((denom.abs() >= _EPS) & (t >= 0.0) & (t <= 1.0)
                 & (u >= 0.0) & (u <= 1.0))
    ix = ax[:, None] + t * d1x
    iy = ay[:, None] + t * d1y

    batch = ax.shape[1:]
    px = torch.cat([ax, bx, ix.reshape((16,) + batch)], dim=0)
    py = torch.cat([ay, by, iy.reshape((16,) + batch)], dim=0)
    valid = torch.cat([a_in_b, b_in_a, seg_valid.reshape((16,) + batch)], dim=0)
    vf = valid.to(ax.dtype)
    cnt = vf.sum(0)
    denom_c = torch.clamp(cnt, min=1.0)
    cx0 = (px * vf).sum(0) / denom_c
    cy0 = (py * vf).sum(0) / denom_c

    # Angular order around the centroid as comparison-counting ranks.
    ang = torch.atan2(py - cy0[None], px - cx0[None])
    key = torch.where(valid, ang, torch.full_like(ang, _BIG))
    n = key.shape[0]
    idx = torch.arange(n, device=key.device).reshape((n,) + (1,) * len(batch))
    ki, kj = key[:, None], key[None, :]
    lt = (kj < ki) | ((kj == ki) & (idx[None, :] < idx[:, None]))
    rank = lt.sum(1)  # (24, ...) unique per slot

    # sorted[r] = candidate whose rank == r
    onehot = (rank[:, None] == idx[None, :]).to(ax.dtype)  # (24i, 24r, ...)
    sx = (onehot * px[:, None]).sum(0)
    sy = (onehot * py[:, None]).sum(0)

    # Masked shoelace over the first cnt sorted entries; the wrap-around
    # term (last live -> first) replaces the rolled pairing at r == cnt-1.
    r_iota = idx.expand_as(valid)
    live = (r_iota.to(ax.dtype) < cnt[None]).to(ax.dtype)
    is_last = (r_iota + 1 == cnt[None].long()).to(ax.dtype)
    nx = torch.roll(sx, -1, dims=0) * (1 - is_last) + sx[0][None] * is_last
    ny = torch.roll(sy, -1, dims=0) * (1 - is_last) + sy[0][None] * is_last
    area2 = ((sx * ny - nx * sy) * live).sum(0)
    return 0.5 * area2.abs()


def _hull_area_xy(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Convex-hull area of small point sets: px, py (V, ...) -> (...).

    An edge qualifies iff every point k is strictly left of it or collinear
    and within it (only the maximal collinear edge), and neither endpoint
    repeats an earlier point; each hull edge then appears once, CCW, and the
    origin-based shoelace over qualifying edges is twice the area. All-
    collinear or all-duplicate sets qualify both directions of an edge,
    whose terms cancel to area 0."""
    scale = px.abs().amax(0) + py.abs().amax(0) + 1.0
    eps = _EPS * scale  # length-scaled; predicates only
    eps2 = eps * scale
    v = px.shape[0]
    ddx = px[:, None] - px[None, :]  # (i, i', ...)
    ddy = py[:, None] - py[None, :]
    coincide = (ddx.abs() <= eps) & (ddy.abs() <= eps)
    idx = torch.arange(v, device=px.device)
    earlier = (idx[None, :] < idx[:, None]).reshape((v, v) + (1,) * (px.dim() - 1))
    rep = ~torch.any(coincide & earlier, dim=1)  # (V, ...)

    ex, ey = -ddx, -ddy  # (i, j, ...): p_j - p_i
    len2 = ex * ex + ey * ey
    rx = -ddx[:, None]  # p_k - p_i laid out (i, 1, k, ...)
    ry = -ddy[:, None]
    cross = rx * ey[:, :, None] - ry * ex[:, :, None]
    t = rx * ex[:, :, None] + ry * ey[:, :, None]
    ok = (cross > eps2) | ((cross.abs() <= eps2) & (t >= -eps2)
                           & (t <= len2[:, :, None] + eps2))
    edge = (torch.all(ok, dim=2) & (len2 > eps2) & rep[:, None] & rep[None, :])
    area2 = ((px[:, None] * py[None, :] - px[None, :] * py[:, None])
             * edge.to(px.dtype)).sum(dim=(0, 1))
    return 0.5 * area2.abs()


def _hull_area_8(pts: torch.Tensor) -> torch.Tensor:
    """Convex-hull area of (8, 2) points (single set; see `_hull_area_xy`)."""
    return _hull_area_xy(pts[:, 0], pts[:, 1])


def intersection_area(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise intersection area of aligned box arrays (..., 5)."""
    ax, ay = _corners_xy(boxes1)
    bx, by = _corners_xy(boxes2)
    return _intersection_area_xy(ax, ay, bx, by)


def rotated_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise rotated IoU of aligned (..., 5) box arrays."""
    inter = intersection_area(boxes1, boxes2)
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    return inter / torch.clamp(a1 + a2 - inter, min=_EPS)


def rotated_giou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise rotated (GIoU, IoU) of aligned (..., 5) box arrays:
    GIoU = IoU - (hull_area - union) / hull_area, the hull over the 8
    corners (reference: src/utils/iou_rotated_boxes_utils.py:98-142)."""
    inter = intersection_area(boxes1, boxes2)
    ax, ay = _corners_xy(boxes1)
    bx, by = _corners_xy(boxes2)
    hull = _hull_area_xy(torch.cat([ax, bx], dim=0), torch.cat([ay, by], dim=0))
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    eps = torch.tensor(_EPS, dtype=inter.dtype, device=inter.device)
    union = torch.maximum(a1 + a2 - inter, eps)
    iou = inter / union
    giou = iou - (hull - union) / torch.maximum(hull, eps)
    return giou, iou


def pairwise_rotated_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) rotated IoU matrix (eval matching), on the
    device the boxes lie on."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    b1 = boxes1[:, None, :].expand(n, m, 5)
    b2 = boxes2[None, :, :].expand(n, m, 5)
    return rotated_iou(b1, b2)
