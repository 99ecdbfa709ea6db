"""extract_mfu.pushdown: the benchmark's model FLOPs of the window's POSTs (the prefix's forward) over the window's host seconds, in percent of 989 TFLOP/s (bf16, dense)."""
from hapibench.readings import mfu


def read(r):
    return mfu(r, "pushdown")
