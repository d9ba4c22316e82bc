"""The port's packaging rules: it never imports JAX, its device policy
follows USEGPU, and its kernel build is keyed by its sources.

The import check runs in a subprocess: this test process already holds
jax (``tests/conftest.py`` imports it).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_port_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import jurassic_torch, jurassic_torch.forward, "
        "jurassic_torch.ops.ega_fused, jurassic_torch.cli.formod, "
        "jurassic_torch.workloads, jurassic_torch.ops._build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib') or m in ('jurassic_tpu.geometry', "
        "'jurassic_tpu.forward', 'jurassic_tpu.ops.continua', "
        "'jurassic_tpu.ops.pallas'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_device_policy():
    from jurassic_torch.device import resolve_device, tracer_dtype

    assert resolve_device(0) == torch.device("cpu")
    assert tracer_dtype("cpu") == torch.float64
    assert tracer_dtype("cuda") == torch.float32
    with pytest.raises(ValueError, match="USEGPU = 1"):
        resolve_device(1, "cpu")
    if torch.cuda.is_available():
        assert resolve_device(-1).type == "cuda"
        with pytest.raises(ValueError, match="USEGPU = 0"):
            resolve_device(0, "cuda")
    else:
        assert resolve_device(-1) == torch.device("cpu")
        with pytest.raises(ValueError, match="no CUDA device"):
            resolve_device(1)


def test_build_key_follows_sources(tmp_path, monkeypatch):
    """An edited kernel source gets a new library name (so it rebuilds);
    an unchanged one keeps its name."""
    from jurassic_torch.ops import _build

    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.sources():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    name0 = _build.library_path()
    assert name0.parent == tmp_path / "_build"
    assert _build.library_path() == name0
    cu = next(src.glob("*.cu"))
    cu.write_text(cu.read_text() + "\n// edited\n")
    assert _build.library_path() != name0
    assert _build.build_log() == ""
