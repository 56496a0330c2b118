"""The port's kernels and ops. Importing this package registers the hand
kernels as `torch.library` custom ops (``cyv4::stem_conv3x3``,
``cyv4::conv3x3``, ``cyv4::fused_stage``): a program exported with
`torch.export` that calls them loads only after this import."""

from . import conv3x3, fused_stage, stem_conv  # noqa: F401  (registers the ops)
