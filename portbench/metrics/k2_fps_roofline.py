"""``k2_fps_roofline``: K2's share of its roofline over the traced
window, in percent: the summed least time of every K2 launch
(``roofline.k2_fps`` of its shape) over their summed device time (the
CUDA events around each launch); nothing without a launch."""

from portbench import roofline


def read(record):
    return roofline.share_percent(record["kernels"].get("k2", []),
                                  roofline.k2_fps)
