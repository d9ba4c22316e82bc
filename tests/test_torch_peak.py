"""The peak probes' plain PyTorch versions and rate arithmetic on the CPU
(the CUDA probes themselves run only on a card:
``tests/test_torch_kernel_cuda.py`` and ``chip_smoke.py``).

The plain versions are checked against closed forms: the FMA chain
acc <- acc x + c is a geometric series, the special-function chains
converge to the fixed points of their maps.  Tolerances: 1e-5 relative
(float32 recurrences of up to 64 steps against float64 closed forms).
They are also held to the Pallas probes they port, ``tools/vpu_peak.py``
``_fma_kernel`` and ``_exp_kernel`` in interpret mode, from the same
accumulators over the same number of steps, at 1e-6 relative.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from jurassic_torch.tools import peak


def test_probe_init_is_seeded_and_shaped():
    a, b = peak.probe_init(2), peak.probe_init(2)
    assert a.shape == (2 * peak.THREADS, peak.NACC)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, peak.probe_init(2, seed=1))
    assert 0.1 <= float(a.min()) and float(a.max()) <= 0.9


@pytest.mark.parametrize("loops", [0, 1, 2])
def test_fma_ref_is_the_geometric_series(loops):
    init = peak.probe_init(1)
    n = loops * peak.INNER
    x = float(np.float32(peak.FMA_X))
    c = float(np.float32(peak.FMA_C))
    want = init.double() * x ** n + c * (1 - x ** n) / (1 - x)
    got = peak.fma_probe(init, loops)      # CPU tensor: the plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    if loops == 0:
        assert torch.equal(got, init)


@pytest.mark.parametrize("op, fixed", [
    ("expf", 0.5671432904097838),      # x = exp(-x)
    ("ex2", 0.6411857445049860),       # x = 2^-x
    ("lg2", 1.6598611779191825)])      # x = log2(x + 1.5)
def test_sfu_ref_converges_to_its_fixed_point(op, fixed):
    init = peak.probe_init(1)
    one = peak.sfu_ref(init, op, 1)
    assert not torch.equal(one, init)
    got = peak.sfu_probe(init, op, 8)
    np.testing.assert_allclose(got.numpy(), fixed, rtol=1e-5)
    # one step, by hand
    step = {"expf": lambda a: math.exp(-a), "ex2": lambda a: 2.0 ** -a,
            "lg2": lambda a: math.log2(a + 1.5)}[op]
    a = float(init[3, 5])
    for _ in range(peak.SFU_INNER):
        a = step(a)
    assert abs(float(one[3, 5]) - a) <= 1e-5 * abs(a)
    with pytest.raises(ValueError, match="op must be"):
        peak.sfu_ref(init, "sin", 1)


def test_sfu_ref_tells_the_step_count_after_one_loop():
    """One loop iteration leaves every chain far enough from its fixed
    point that one step more or fewer misses the probes' 1e-5 bar by a
    hundred times: this is what lets the card check count the steps."""
    init = peak.probe_init(1)
    for op in peak.SFU_OPS:
        ref = peak.sfu_ref(init, op, 1)
        assert torch.equal(ref, peak.sfu_steps(init, op, peak.SFU_INNER))
        for k in (peak.SFU_INNER - 1, peak.SFU_INNER + 1):
            off = ((peak.sfu_steps(init, op, k) - ref).abs() / ref.abs())
            assert float(off.max()) > 1e-3, (op, k)


def _vpu_peak():
    path = Path(__file__).resolve().parent.parent / "tools" / "vpu_peak.py"
    spec = importlib.util.spec_from_file_location("vpu_peak", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("probe", ["fma", "exp"])
@pytest.mark.parametrize("loops", [0, 1])
def test_plain_versions_match_the_pallas_probes(probe, loops):
    """``_fma_kernel`` / ``_exp_kernel`` through ``pl.pallas_call`` in
    interpret mode against ``fma_steps`` (with the Pallas probe's x and
    c) / ``sfu_steps("expf")``: the same starting accumulators
    0.1 (i + 1) / 0.001 (i + 1), the same ``loops * INNER / NACC`` steps
    of every chain, summed over the chains.  1e-6 relative (float32
    rounding of up to 64 steps and of the sum's order)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    vp = _vpu_peak()
    assert vp.NACC == peak.NACC
    factory = vp._fma_kernel if probe == "fma" else vp._exp_kernel
    want = np.asarray(pl.pallas_call(
        factory(loops),
        out_shape=jax.ShapeDtypeStruct(vp.SHAPE, jnp.float32),
        interpret=True)())
    steps = loops * vp.INNER // vp.NACC
    first = 0.1 if probe == "fma" else 0.001
    init = (first * torch.arange(1, peak.NACC + 1, dtype=torch.float64)
            ).float().repeat(peak.THREADS, 1)
    if probe == "fma":
        got = peak.fma_steps(init, steps, x=1.0000001, c=1e-12)
    else:
        got = peak.sfu_steps(init, "expf", steps)
    got = got.sum(dim=1).numpy()
    assert steps == 64 * loops and want.shape == vp.SHAPE
    np.testing.assert_allclose(got, want.reshape(-1)[:got.size], rtol=1e-6)
    np.testing.assert_allclose(want, want[0, 0], rtol=0)


def test_copy_ref_copies():
    src = torch.arange(16, dtype=torch.float32)
    out = peak.copy_probe(src, blocks=1)
    assert torch.equal(out, src) and out.data_ptr() != src.data_ptr()


def test_two_point_rate():
    """The second unit of work took t2 - t1: a fixed overhead cancels."""
    overhead, per_unit = 0.004, 0.010
    t1, t2 = overhead + per_unit, overhead + 2 * per_unit
    assert peak.two_point_rate(5e9, t1, t2) == pytest.approx(5e11)
    assert peak.two_point_rate(1.0, 1.0, 1.0) == pytest.approx(1e9)
    assert peak.SFU_LOOPS * peak.SFU_INNER == peak.LOOPS * peak.INNER
    # FMA accounting: 2 operations per chain step
    steps = 4 * peak.THREADS * peak.NACC * peak.INNER * 8
    assert peak.two_point_rate(2 * steps, 1.0, 2.0) == 2 * steps


def test_probes_refuse_malformed_input():
    with pytest.raises(ValueError, match="blocks"):
        peak._blocks(torch.zeros(10, peak.NACC))
    with pytest.raises(ValueError, match="blocks"):
        peak._blocks(torch.zeros(peak.THREADS, 3))
    assert peak._blocks(peak.probe_init(3)) == 3


def test_measure_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        peak.measure(force=True)
