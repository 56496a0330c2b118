"""Command-line entry points of the port (`python -m complex_yolov4_tpu_torch.cli.<name>`)."""
