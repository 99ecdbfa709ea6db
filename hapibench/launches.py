"""The port's kernel launches a step or a POST of a cell makes, worked out
from the cell as ``chip_smoke.train_launches`` works them out (the traffic
kind's ``launches``), and the bound of one launch of each at the cell's
shape (the family's ``kernel_work`` for its mixer kernels, the int8
boundary's here). The run holds the launches the program counted
(``ops.launch_counts()``) against these.

Every launch in these cells runs at one shape a kernel: a microbatch of the
COS batch's rows at the mix's sequence length.
"""
from __future__ import annotations

from typing import Dict

from hapibench import families, kinds, work

INT8 = ("quantize_int8", "dequantize_int8")


def per_unit(config: dict, traffic: dict) -> Dict[str, int]:
    """Launches of each kernel in one step or POST."""
    return kinds.of(traffic).launches(families.of(config).KERNELS, config, traffic)


def family_of(config: dict, kernel: str) -> str:
    """The roofline a kernel's launches count towards."""
    return "int8" if kernel in INT8 else families.of(config).ROOFLINE


def launch_bound_s(config: dict, traffic: dict, kernel: str) -> float:
    """The bound of one launch of ``kernel`` at the cell's shape."""
    m = config["model"]
    b, s, d = traffic["hapi"]["cos_batch"], traffic["seq"], m["d_model"]
    item = work.ITEMSIZE[m["compute_dtype"]]
    if kernel not in INT8:
        peak = work.PEAK_BF16 if item == 2 else work.PEAK_F32
        return work.bound_s(families.of(config).kernel_work(m, b, s, kernel), peak)
    n = b * s * d
    fn = work.quantize_work if kernel == "quantize_int8" else work.dequantize_work
    return work.bound_s(fn(n, item, n // 128), work.PEAK_F32)


def bounds(config: dict, traffic: dict, counted: Dict[str, int]) -> Dict[str, float]:
    """Each roofline's summed bound over the launches ``counted``."""
    out: Dict[str, float] = {}
    for kernel, n in counted.items():
        if n:
            fam = family_of(config, kernel)
            out[fam] = out.get(fam, 0.0) + n * launch_bound_s(config, traffic, kernel)
    return out


def expected(config: dict, traffic: dict, units: int) -> Dict[str, int]:
    return {k: v * units for k, v in per_unit(config, traffic).items()}
