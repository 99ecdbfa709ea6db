"""Adversarial inputs for the int8 quantizer, where one that is not bit-exact
shows. Data only (numpy): the port's tests and ``chip_smoke.py`` hold the
kernel and the plain version to each other on them."""
from __future__ import annotations

import numpy as np

INT8_ADVERSARIAL = ("ties", "zero tiles", "one large", "subnormal")


def int8_adversarial(case: str) -> np.ndarray:
    """f32 inputs, exact in bf16: x / scale exactly k + 0.5 (a power-of-two
    scale, so rint's ties go to even), all-zero tiles (scale 1e-8 / 127) and
    an all-zero row, one element of 1e30 in each tile of small values, and
    subnormal values (with and without a normal element in the tile)."""
    rng = np.random.default_rng(INT8_ADVERSARIAL.index(case) + 40)
    if case == "ties":
        s0 = 2.0 ** -3                          # the scale: 127 s0 / 127 is s0 exactly
        x = (rng.integers(-127, 127, (64, 40, 128)) + 0.5) * s0
        top = 127 * s0 * rng.choice([-1.0, 1.0], (64, 40, 1))
        np.put_along_axis(x, rng.integers(0, 128, (64, 40, 1)), top, axis=-1)
        return x.reshape(64, 5120).astype(np.float32)
    if case == "zero tiles":
        x = rng.standard_normal((33, 3, 128)) * 2
        x[:, 0] = 0.0
        x[5] = 0.0
        return x.reshape(33, 384).astype(np.float32)
    if case == "one large":
        x = rng.standard_normal((17, 40, 128)) * 1e-3
        big = 1e30 * rng.choice([-1.0, 1.0], (17, 40, 1))
        np.put_along_axis(x, rng.integers(0, 128, (17, 40, 1)), big, axis=-1)
        return x.reshape(17, 5120).astype(np.float32)
    x = rng.standard_normal((9, 5, 128)) * 1e-39    # below f32's (and bf16's) least normal
    x[:, ::2, 7] = 3e-30
    x[:, 1, 3] = -0.0
    return x.reshape(9, 640).astype(np.float32)
