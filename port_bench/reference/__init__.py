"""The plain references that decide `correct`: plain PyTorch and numpy,
importing neither JAX, nor the JAX package, nor anything of the port.
They take only what the benchmark made (weights, raw points, cells) and
work out everything else again: the raster, the int8 scales, the decode
and the NMS."""
