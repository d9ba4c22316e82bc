"""The port's packaging rules: it imports neither JAX nor the JAX
package, its device policy follows USEGPU, and its kernel build is keyed
by its sources.

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
    """Importing every module of the port (and building a workload)
    loads no jax* and no jurassic_tpu* module.  In a subprocess: this
    process already holds both."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "jurassic_torch").rglob("*.py")
        if "_build" not in p.parts)
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert "jurassic_torch.tools.peak" in mods and len(mods) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from jurassic_torch.workloads import small_limb\n"
        "small_limb(ng=2, nd=3, nr=2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'jurassic_tpu'))\n"
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
    name1 = _build.library_path()
    assert name1 != name0
    # the shared header is part of the key too
    cuh = src / "ega_common.cuh"
    assert cuh in _build.sources()
    cuh.write_text(cuh.read_text() + "\n// edited\n")
    assert _build.library_path() not in (name0, name1)
    assert _build.build_log() == ""
    # every entry point has its argument types in one table
    assert set(_build.ENTRY_POINTS) == {
        "jt_ega_fused_turbo", "jt_ega_fused_table", "jt_peak_fma",
        "jt_peak_sfu", "jt_peak_copy"}
