"""step_mfu.train: the benchmark's model FLOPs of the window's fine-tune steps over the window's host seconds, in percent of 989 TFLOP/s (bf16, dense)."""
from hapibench.readings import mfu


def read(r):
    return mfu(r, "train")
