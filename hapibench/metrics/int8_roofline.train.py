"""int8_roofline.train: the int8 quantize and dequantize launches' summed bounds over those kernels' device time in the traced window, in percent."""
from hapibench.readings import roofline


def read(r):
    return roofline(r, "train", "int8")
