"""The benchmark of the PyTorch/CUDA port (`complex_yolov4_tpu_torch`).

`python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once on a CUDA card and prints one JSON line.
Everything is found by name from `BENCHMARK.json`: the cell's file in
`workloads/`, its configuration in `configs/`, its traffic mix in
`traffic/`, the generator the mix names in `generators/`, and each
per-layer metric's reader in `metrics/<name>.py`.

The yardstick lives here and imports nothing of the program: `frozen/`
(input generation, weights, the work and roofline arithmetic) and
`reference/` (the plain forward, raster, decode and NMS that
decide `correct`). Only the generators import the port.
"""
