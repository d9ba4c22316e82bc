"""The cells of ``BENCHMARK.json`` cut to a size a CPU test holds: the
same files, with the scan, the channels, the tables and the step budget
shrunk (nothing here is a configuration of the benchmark)."""
from __future__ import annotations

import io

import torch

from h100bench import harness

TINY_CFG = dict(nd=5, tblnp=8, tblnt=5, tblnu=48, nlos=48, rayds=50.0,
                raydz=5.0, scan_dz=5.0)
TINY_TRAFFIC = dict(pool=4, check_rays=4, check_calls=2, warmup=1)
SEED = 2**31 + 12345


def bench() -> dict:
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def spec(workload: str, b: dict | None = None) -> tuple:
    w, cfg, traffic, limits = harness.cell_spec(b or bench(), workload)
    return w, dict(cfg, **TINY_CFG), dict(traffic, **TINY_TRAFFIC), limits


def run(workload: str, trace: bool = False, seed: int = SEED,
        seconds: float = 1.0, b: dict | None = None, sp=None) -> dict:
    """One run of the cut cell on the CPU, the look for a card skipped."""
    torch.set_num_threads(1)
    b = b or bench()
    return harness.run_cell(workload, seed, seconds, trace, bench=b,
                            spec=sp or spec(workload, b), device="cpu",
                            require_cuda=False, out=io.StringIO(),
                            err=io.StringIO())
