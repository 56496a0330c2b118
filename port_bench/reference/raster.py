"""The BEV raster of cropped points, plain torch on the points' device, as
the served format defines it: per cell of the 609 x 609 grid (50/608 m,
y offset +304), channel 0 the intensity of the highest point (the largest
among points at that height) in steps of 1/255, channel 1 the max height
over 4 m in steps of 1/(2^18 - 1), channel 2 min(1, log(count + 1) /
log 64) with the count saturated at 63, cropped to 608 x 608; rows are
lidar x, columns lidar y.

Written from the definition with scatter-max reductions, apart from the
benchmark's own COO aggregation (`frozen.scenes.aggregate_cells`, a sort),
so that the two check each other. The cell of a point is floor(x / d) in
f32 by a true division (a tensor divisor: a scalar one would multiply by
its reciprocal and move points on a cell edge).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

BEV = 608
GRID = BEV + 1
DISC = float(np.float32(50.0 / BEV))
MAX_HEIGHT = 4.0
HQ_MAX = (1 << 18) - 1
DENSITY = np.minimum(1.0, np.log(np.arange(64, dtype=np.float64) + 1.0)
                     / np.log(64.0)).astype(np.float32)


def raster_one(points: torch.Tensor) -> torch.Tensor:
    """Cropped, z-shifted (N, 4) f32 points -> (608, 608, 3) f32."""
    dev = points.device
    disc = torch.full_like(points[:, 0], DISC)
    ix = torch.floor(points[:, 0] / disc).long()
    iy = (torch.floor(points[:, 1] / disc) + GRID / 2).long()
    cell = ix * GRID + iy
    z, r = points[:, 2].double(), points[:, 3].double()
    n = GRID * GRID
    height = torch.full((n,), -float("inf"), dtype=torch.float64, device=dev)
    height.scatter_reduce_(0, cell, z, "amax")
    top = z >= height[cell]
    intensity = torch.full((n,), -float("inf"), dtype=torch.float64, device=dev)
    intensity.scatter_reduce_(0, cell[top], r[top], "amax")
    count = torch.bincount(cell, minlength=n)
    occ = count > 0
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rq = torch.round(torch.clamp(intensity[occ], 0.0, 1.0) * 255.0).float()
    out[occ, 0] = rq * torch.tensor(1.0 / 255.0, dtype=torch.float32)
    hq = torch.round(torch.clamp(height[occ] / MAX_HEIGHT, 0.0, 1.0) * HQ_MAX).float()
    out[occ, 1] = hq * torch.tensor(1.0 / HQ_MAX, dtype=torch.float32)
    out[occ, 2] = torch.from_numpy(DENSITY).to(dev)[torch.clamp(count[occ], max=63)]
    return out.reshape(GRID, GRID, 3)[:BEV, :BEV]


def raster(clouds: Sequence[np.ndarray], device) -> torch.Tensor:
    """(B, 608, 608, 3) f32 on `device` of B cropped clouds."""
    return torch.stack([raster_one(torch.as_tensor(c, device=device)) for c in clouds])

