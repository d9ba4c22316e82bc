"""The benchmark's inputs, made from a configuration file and a seed.

A configuration names its generators, each a file found by its name:
``"tables"`` -> ``gen/tables/<name>.py``, ``"geometry"`` ->
``gen/geometry/<name>.py`` and ``"atmosphere"`` ->
``gen/atmosphere/<name>.py``, each with ``make(cfg)``.  The tables
(``(fast tables, u rows or None)``, the exact form where u is given)
and the geometry are fixed by the configuration: they stand for an
instrument and a scan.  What ``--seed`` draws is here: the pool of
atmospheres a run's calls cycle through, and the calls and rays the
check compares.  Everything is plain arrays; the entries hand them to
the program in its own types, the reference reads them as they are.
"""
from __future__ import annotations

import numpy as np

from .. import harness


def make(kind: str, cfg: dict):
    """What the configuration's generator of ``kind`` makes."""
    return harness.module(f"gen/{kind}", cfg[kind]).make(cfg)


class Inputs:
    """The configuration's tables and geometry, and the pool of
    atmospheres drawn from the seed (plain arrays).  ``tables`` passes
    tables already made."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, tables=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.ft, self.u = make("tables", cfg) if tables is None else tables
        self.geo = make("geometry", cfg)
        self.pool = atmosphere_pool(make("atmosphere", cfg), traffic, seed)
        self.nr = self.geo["vpz"].size
        self.rows = check_sample(traffic, seed, self.nr)


def _smooth(rng, z: np.ndarray, ztop: float) -> np.ndarray:
    """A smooth profile in [-1, 1]-ish: three sines of random phase and
    weight over the altitude range."""
    out = np.zeros_like(z)
    for j in (1, 2, 3):
        out += rng.uniform(-1.0, 1.0) / j * np.sin(
            2.0 * np.pi * j * z / ztop + rng.uniform(0.0, 2.0 * np.pi))
    return out / 1.8333333333333333


def atmosphere_pool(base: dict, traffic: dict, seed: int) -> list[dict]:
    """``traffic["pool"]`` atmospheres from ``seed``: ``base`` with T
    moved by up to ``t_amp`` K and each gas's vmr scaled by exp(up to
    ``q_amp``), smoothly in altitude.  Every seed gives the same shapes."""
    rng = np.random.default_rng(int(seed))
    ztop = float(base["z"][-1])
    pool = []
    for _ in range(int(traffic["pool"])):
        a = {k: np.array(v) for k, v in base.items()}
        a["t"] = a["t"] + float(traffic["t_amp"]) * _smooth(rng, a["z"], ztop)
        for ig in range(a["q"].shape[0]):
            a["q"][ig] = a["q"][ig] * np.exp(
                float(traffic["q_amp"]) * _smooth(rng, a["z"], ztop))
        pool.append(a)
    return pool


def check_sample(traffic: dict, seed: int, n_rays: int) -> np.ndarray:
    """The rays the check compares, drawn from ``seed``: ray 0 (in a limb
    scan the lowest tangent height, the longest path) and
    ``traffic["check_rays"] - 1`` others, sorted."""
    rng = np.random.default_rng([int(seed), 1])
    m = min(int(traffic["check_rays"]), n_rays)
    rest = rng.choice(np.arange(1, n_rays), size=m - 1, replace=False)
    return np.sort(np.concatenate([[0], rest])).astype(np.int64)


def check_calls(traffic: dict, seed: int, n_calls: int) -> list[int]:
    """The calls of the window the check compares, drawn from ``seed``:
    the last call and ``traffic["check_calls"] - 1`` others."""
    rng = np.random.default_rng([int(seed), 2])
    m = min(int(traffic["check_calls"]), n_calls)
    rest = rng.choice(np.arange(n_calls - 1), size=m - 1, replace=False) \
        if m > 1 else []
    return sorted({int(i) for i in rest} | {n_calls - 1})
