"""The command as the check runs it: without a card (here) it fails and
prints no result; on a card (tests marked ``cuda``) every cell runs a
short window and is correct."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench.tests import tinycell

REPO = Path(__file__).resolve().parents[2]


def _run(cwd: Path, workload: str, seconds: str = "2"):
    return subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload", workload,
         "--seed", str(tinycell.SEED), "--seconds", seconds, "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=1200)


def _printed_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    try:
        return isinstance(json.loads(lines[-1]), dict) if lines else False
    except json.JSONDecodeError:
        return False


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(REPO, "limb_flagship.formod")
    assert r.returncode != 0 and not _printed_result(r.stdout)


def test_benchmark_files_alone_fail(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's own files only
    (no program): no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = _run(tmp_path, "limb_flagship.formod")
    assert r.returncode != 0 and not _printed_result(r.stdout)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      tinycell.bench()["workloads"]])
def test_cell_on_the_card(card, workload):
    r = _run(REPO, workload, "3")
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
