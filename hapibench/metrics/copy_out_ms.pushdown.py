"""copy_out_ms.pushdown: host ms a POST spends from the extraction's end (synchronised) until its int8 codes and scales are numpy on the host."""
from hapibench.readings import per_unit_ms


def read(r):
    return per_unit_ms(r, "pushdown", "copy_out")
