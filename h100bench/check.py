"""The comparison that decides ``correct``.

Once the window has closed, the program's state freed and its memory
peak read, the reference recomputes a sample of the window's answers
drawn from the seed (``gen.check_calls`` / ``gen.check_sample``: the
last call and others, ray 0 and others) from the same inputs, and each
number below that the cell's ``limits/<workload>.json`` names is held
to its limit there.  An entry's ``compare`` (``entries/<entry>.py``)
gives its numbers:

* ``rad_gap``: the widest gap of a radiance, as a share of the largest
  reference radiance of its channel among the compared rays;
* ``tau_gap``: the widest gap of a transmittance (absolute);
* ``k_gap``: the widest gap of a Jacobian entry, as a share of the
  largest reference entry of its block of the state (T, each gas).

A value that is not finite reads as infinitely far.
"""
from __future__ import annotations

import numpy as np


def _gap(a, b) -> np.ndarray:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.where(np.isfinite(d), d, np.inf)


def formod_numbers(got: list, ref: list) -> dict:
    """{rad_gap, tau_gap} of the program's (rad, tau) pairs against the
    reference's, each [r, D]."""
    rad_r = np.stack([r for r, _ in ref])
    scale = np.abs(rad_r).max(axis=(0, 1))
    scale = np.where(scale > 0, scale, 1.0)
    rad_gap = max(float((_gap(g, r) / scale).max())
                  for (g, _), (r, _) in zip(got, ref))
    tau_gap = max(float(_gap(g, r).max()) for (_, g), (_, r) in zip(got, ref))
    return {"rad_gap": rad_gap, "tau_gap": tau_gap}


def jacobian_numbers(got: list, ref: list, blocks: list) -> dict:
    """{k_gap} of the program's K [r, D, n] against the reference's, the
    state split into ``blocks`` (slices of the state axis)."""
    worst = 0.0
    for sl in blocks:
        scale = max(float(np.abs(r[..., sl]).max()) for r in ref)
        scale = scale if scale > 0 else 1.0
        worst = max(worst, max(float(_gap(g[..., sl], r[..., sl]).max())
                               for g, r in zip(got, ref)) / scale)
    return {"k_gap": worst}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (and the limits cover the numbers)."""
    return set(numbers) == set(limits) and all(
        numbers[k] <= float(limits[k]["limit"]) for k in numbers)


def state_blocks(reference, atm: dict) -> list[slice]:
    """The state vector's blocks (T, then each gas) as slices."""
    _, where = reference.state(atm)
    fields = [f for f, _ in where]
    starts = [i for i in range(len(fields))
              if i == 0 or fields[i] != fields[i - 1]]
    return [slice(a, b) for a, b in zip(starts, starts[1:] + [len(fields)])]
