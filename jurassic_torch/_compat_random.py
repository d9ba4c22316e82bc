"""Random-number helper for the climatology CLI's RAND option (the
port's own copy of ``jurassic_tpu/_compat_random.py``).

The reference uses GSL's default mt19937 generator with seed 0
(gsl_rng_uniform_pos, climatology.c:67-71).  We use NumPy's MT19937 with
the same seeding convention; sequences are reproducible but not identical
to GSL's (the RAND path is a perturbation feature, not a golden-file one).
"""
from __future__ import annotations

import numpy as np


def ref_uniform_sequence(seed: int = 0):
    rng = np.random.Generator(np.random.MT19937(seed))
    while True:
        x = rng.random()
        if x > 0.0:  # gsl_rng_uniform_pos excludes 0
            yield x
