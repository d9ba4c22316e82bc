"""What a run loads: no JAX and no JAX package anywhere; no program in
the reference."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from h100bench import importcheck

REPO = Path(__file__).resolve().parents[2]


def _loaded(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True).stdout
    return set(out.split()[-1000:])


def test_reference_loads_no_program():
    tops = _loaded("import h100bench.reference.forward, "
                   "h100bench.reference.physics, h100bench.roofline, "
                   "h100bench.check\n"
                   "from h100bench import gen\n"
                   "from h100bench.tests import tinycell\n"
                   "for w in ('limb_flagship.formod', 'limb_wide_exact.formod'):\n"
                   "    _, cfg, traffic, _ = tinycell.spec(w)\n"
                   "    gen.Inputs(cfg, traffic, 3)")
    assert not tops & {"jurassic_torch", *importcheck.FORBIDDEN}


def test_a_run_loads_no_jax():
    tops = _loaded("from h100bench.tests import tinycell\n"
                   "r = tinycell.run('limb_wide_exact.formod', trace=True)\n"
                   "assert r['correct']")
    assert "jurassic_torch" in tops
    assert not tops & set(importcheck.FORBIDDEN)


def test_loaded_compares_top_level_names_whole():
    mods = {"jurassic_torch.forward": 0, "jaxtyping": 0, "jax.numpy": 0,
            "jurassic_tpu": 0}
    assert importcheck.loaded(modules=mods) == ["jax.numpy", "jurassic_tpu"]
