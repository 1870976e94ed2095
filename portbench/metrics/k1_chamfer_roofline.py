"""``k1_chamfer_roofline``: K1's share of its roofline over the traced
window, in percent: the summed least time of every K1 launch
(``roofline.k1_chamfer`` of its shape) over their summed device time (the
CUDA events around each launch); nothing without a launch."""

from portbench import roofline


def read(record):
    return roofline.share_percent(record["kernels"].get("k1", []),
                                  roofline.k1_chamfer)
