"""extract_ms.train: host ms a step spends in the frozen prefix's extraction, over its microbatches (make_extract_fn's function, synchronised at both ends)."""
from hapibench.readings import per_unit_ms


def read(r):
    return per_unit_ms(r, "train", "extract")
