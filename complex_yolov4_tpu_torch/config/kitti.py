"""KITTI geometry / dataset constants for the BEV detection task.

A copy of `complex_yolov4_tpu/config/kitti.py` (reference:
src/config/kitti_config.py:3-66): class id map with Van->Car and
Person_sitting->Pedestrian, the front BEV boundary x in [0,50] m, y in
[-25,25] m, z in [-2.73,1.27] m, a 608x608 raster with cell size
(maxX-minX)/608, and the dataset-average calibration matrices used when no
per-frame calib is available. `tests/test_torch_port_copies.py` holds the
copy equal to the original.
"""

from __future__ import annotations

import numpy as np

CLASS_NAMES = ("Car", "Pedestrian", "Cyclist")
NUM_CLASSES = len(CLASS_NAMES)

CLASS_NAME_TO_ID = {
    "Car": 0,
    "Pedestrian": 1,
    "Cyclist": 2,
    "Van": 0,
    "Person_sitting": 1,
}

# Front side (of vehicle) point-cloud boundary for the BEV raster (meters,
# velodyne frame: x forward, y left, z up).
BOUNDARY = {
    "minX": 0.0,
    "maxX": 50.0,
    "minY": -25.0,
    "maxY": 25.0,
    "minZ": -2.73,
    "maxZ": 1.27,
}

# Back side boundary (defined for parity; unused by the standard pipeline, same
# as in the reference).
BOUNDARY_BACK = {
    "minX": -50.0,
    "maxX": 0.0,
    "minY": -25.0,
    "maxY": 25.0,
    "minZ": -2.73,
    "maxZ": 1.27,
}

BEV_WIDTH = 608  # columns, across lidar y in [-25, 25] m
BEV_HEIGHT = 608  # rows, across lidar x in [0, 50] m

DISCRETIZATION = (BOUNDARY["maxX"] - BOUNDARY["minX"]) / BEV_HEIGHT  # 50/608 m

MAX_HEIGHT = abs(BOUNDARY["maxZ"] - BOUNDARY["minZ"])  # 4.0 m, height normalizer

# BGR drawing colors per class (Car, Pedestrian, Cyclist).
COLORS = ((0, 255, 255), (0, 0, 255), (255, 0, 0))

# Average KITTI calibration (used by the demo path when per-frame calib files
# are unavailable; values are dataset means, reference: src/config/kitti_config.py:42-65).
Tr_velo_to_cam = np.array(
    [
        [7.49916597e-03, -9.99971248e-01, -8.65110297e-04, -6.71807577e-03],
        [1.18652889e-02, 9.54520517e-04, -9.99910318e-01, -7.33152811e-02],
        [9.99882833e-01, 7.49141178e-03, 1.18719929e-02, -2.78557062e-01],
        [0, 0, 0, 1],
    ]
)

R0 = np.array(
    [
        [0.99992475, 0.00975976, -0.00734152, 0],
        [-0.0097913, 0.99994262, -0.00430371, 0],
        [0.00729911, 0.0043753, 0.99996319, 0],
        [0, 0, 0, 1],
    ]
)

P2 = np.array(
    [
        [719.787081, 0.0, 608.463003, 44.9538775],
        [0.0, 719.787081, 174.545111, 0.1066855],
        [0.0, 0.0, 1.0, 3.0106472e-03],
        [0.0, 0.0, 0.0, 0.0],
    ]
)

R0_inv = np.linalg.inv(R0)
Tr_velo_to_cam_inv = np.linalg.inv(Tr_velo_to_cam)
P2_inv = np.linalg.pinv(P2)
