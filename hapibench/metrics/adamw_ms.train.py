"""adamw_ms.train: host ms a step spends in adamw_update (synchronised at both ends)."""
from hapibench.readings import per_unit_ms


def read(r):
    return per_unit_ms(r, "train", "adamw")
