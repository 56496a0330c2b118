"""File + console logger (reference: src/utils/logger.py:5-38), gated to the
lead process in multi-process runs.

A copy of `complex_yolov4_tpu/utils/logger.py`;
`tests/test_torch_port_copies.py` holds the copy equal to the original.
"""

from __future__ import annotations

import logging
import os
from typing import Optional


def create_logger(logs_dir: Optional[str], saved_fn: str,
                  is_lead: bool = True) -> logging.Logger:
    logger = logging.getLogger(f"complex_yolov4_tpu.{saved_fn}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    logger.handlers.clear()
    if not is_lead:
        logger.addHandler(logging.NullHandler())
        return logger

    fmt = logging.Formatter("%(asctime)s %(levelname)s  %(message)s")
    stream = logging.StreamHandler()
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    if logs_dir:
        os.makedirs(logs_dir, exist_ok=True)
        fileh = logging.FileHandler(
            os.path.join(logs_dir, f"logger_{saved_fn}.txt"))
        fileh.setFormatter(fmt)
        logger.addHandler(fileh)
    return logger
