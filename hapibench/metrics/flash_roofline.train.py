"""flash_roofline.train: the flash forward and backward launches' summed bounds over those kernels' device time in the traced window, in percent."""
from hapibench.readings import roofline


def read(r):
    return roofline(r, "train", "flash")
