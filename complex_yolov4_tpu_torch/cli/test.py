"""Inference / demo CLI of the port (reference entry point parity: src/test.py).

Counterpart of `complex_yolov4_tpu/cli/test.py`: the same flags
(`config.runtime.TestConfig`), plus ``--device`` (default ``cuda``; raises
without CUDA unless ``--device cpu``). It serves the test split through
`make_inference_fn` (points by default: the loader ships padded points and
the card rasters them; ``--host_raster``: host-rastered images), bf16 by
default, ``--quantize int8`` and ``FUSED_STAGE=1`` as in `cli.evaluate`,
and prints per batch the ms per frame, frames/s and detections per frame.

Outputs are drawn only when asked for: ``--save_test_output`` (one .jpg per
frame, or one .avi with ``--output_format video``) and ``--show_image``
draw the rotated boxes on the BEV map (and on the camera image where the
frame has one) with OpenCV, and raise before the run starts where `cv2`
is not installed; ``--save_3d`` writes one interactive HTML viewer per
frame (numpy only).

Usage (synthetic smoke on the CPU):
    python -m complex_yolov4_tpu_torch.cli.test --synthetic \\
        --model complex_yolov4_tiny --num_samples 2 --device cpu
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from ..config.runtime import parse_test_config
from ..data.kitti import Calibration, default_calibration
from ..data.loader import create_test_loader
from ..evaluation.evaluator import make_inference_fn
from ..utils.meters import time_synchronized
from . import common


def _require_cv2(configs) -> None:
    """The drawing flags need OpenCV: raise now, before the run, if it is
    missing."""
    flags = [f"--{n}" for n in ("save_test_output", "show_image") if getattr(configs, n)]
    if not flags:
        return
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{' and '.join(flags)} draw with OpenCV, and cv2 is not "
                          "installed: install opencv-python or drop the flag(s) "
                          "(--save_3d needs no cv2)") from e


def _draw(ds, sample_id: int, image: np.ndarray, dets: np.ndarray,
          masks: np.ndarray) -> np.ndarray:
    """The frame's BEV map with its detections, under its camera image with
    the projected boxes where the frame has one (uint8 BGR)."""
    import cv2

    from ..utils import visualization as viz

    bev_img = viz.bev_to_uint8(image)
    viz.draw_detections_bev(bev_img, dets, masks)
    bev_img = cv2.rotate(bev_img, cv2.ROTATE_180)
    calib_path = os.path.join(ds.paths["calib"], f"{sample_id:06d}.txt")
    calib = Calibration(calib_path) if os.path.exists(calib_path) else default_calibration()
    img_path = ds.get_image_path(sample_id)
    if not os.path.exists(img_path):
        return bev_img
    cam = cv2.imread(img_path)
    objects = viz.detections_to_kitti_objects(dets, masks, calib, cam.shape[:2],
                                              float(image.shape[0]))
    viz.draw_objects_on_camera(cam, objects, calib)
    return viz.merge_rgb_to_bev(cam, bev_img, output_width=608)


def _save_3d(configs, ds, sample_id: int, img_size: float, dets, masks) -> None:
    from ..utils.viewer_html import detections_to_lidar_boxes, save_lidar_html

    os.makedirs(configs.results_dir, exist_ok=True)
    labels = detections_to_lidar_boxes(dets, masks, img_size)
    boxes7 = labels[:, 1:]
    boxes7[:, 2] += boxes7[:, 3] / 2.0  # bottom z -> center z
    save_lidar_html(ds.get_lidar(sample_id),
                    os.path.join(configs.results_dir, f"{sample_id:06d}.html"),
                    boxes_lidar=boxes7, box_classes=labels[:, 0],
                    title=f"frame {sample_id:06d} — detections")


def main(argv=None, *, timings: Optional[Dict[str, List[float]]] = None):
    """Run the demo; returns per batch (sample ids, detections (B, 256, 9),
    masks (B, 256)) as numpy arrays.

    timings: a dict that, when given, receives per batch the host seconds
    of the inference call up to a synchronized device ("infer")."""
    configs = parse_test_config(argv)
    _require_cv2(configs)
    device = common.resolve_device(configs)
    dataset_dir = common.resolve_dataset_dir(configs)
    spec = common.resolve_spec(configs)
    params, state = common.init_or_load(spec, configs.pretrained_path)
    # the device rasters compact points by default; the host image stays in
    # the batch for drawing
    device_raster = not configs.host_raster
    loader = create_test_loader(dataset_dir, configs.batch_size,
                                num_samples=configs.num_samples,
                                device_raster=device_raster)
    model = common.maybe_quantize(spec, params, state, configs, loader, device)
    infer = make_inference_fn(conf_thresh=configs.conf_thresh,
                              nms_thresh=configs.nms_thresh, from_points=device_raster)
    draw = configs.save_test_output or configs.show_image
    if configs.save_test_output:
        os.makedirs(configs.results_dir, exist_ok=True)
    if timings is not None:
        timings.setdefault("infer", [])
    ds = loader.dataset
    results = []
    video_writer = None
    try:
        for b_idx, batch in enumerate(loader):
            images = batch["image"]  # host-side, for drawing
            if device_raster:
                args = tuple(batch[k] for k in ("points", "point_mask", "flip", "holes",
                                                "hole_mask"))
            else:
                args = (images,)
            t0 = time_synchronized(device)
            dets, masks = infer(model, *args)
            t1 = time_synchronized(device)
            dets, masks = dets.cpu().numpy(), masks.cpu().numpy()
            n = images.shape[0]
            if timings is not None:
                timings["infer"].append(t1 - t0)
            print(f"batch {b_idx}: {(t1 - t0) * 1000 / n:.1f} ms/frame, "
                  f"{n / max(t1 - t0, 1e-9):.1f} FPS, detections: "
                  f"{masks.sum(axis=-1).astype(int).tolist()}")
            results.append((np.asarray(batch["sample_ids"]), dets, masks))

            for i in range(n):
                sample_id = int(batch["sample_ids"][i])
                if configs.save_3d:
                    _save_3d(configs, ds, sample_id, float(images.shape[1]), dets[i], masks[i])
                if not draw:
                    continue
                import cv2

                out_img = _draw(ds, sample_id, images[i], dets[i], masks[i])
                if configs.save_test_output and configs.output_format == "image":
                    cv2.imwrite(os.path.join(configs.results_dir, f"{sample_id:06d}.jpg"),
                                out_img)
                elif configs.save_test_output and configs.output_format == "video":
                    if video_writer is None:
                        h, w = out_img.shape[:2]
                        video_writer = cv2.VideoWriter(
                            os.path.join(configs.results_dir, configs.output_video_fn + ".avi"),
                            cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
                    video_writer.write(out_img)
                if configs.show_image:
                    cv2.imshow("complex_yolov4_tpu_torch", out_img)
                    if cv2.waitKey(0) & 0xFF == 27:
                        return results
    finally:
        if video_writer is not None:
            video_writer.release()
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
