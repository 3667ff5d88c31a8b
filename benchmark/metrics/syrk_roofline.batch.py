"""The normal-matrix assembly's share of its roofline (roofline.py), over
the window's batched classes, stopped lanes not counted."""

from benchmark.roofline import kernel_share as read  # noqa: F401
