"""The port's table-mode pass against the JAX package's table kernel on one
LOS of the ``ega`` golden, with the gap between them explained.

Run as JAX's own tests run it on the CPU (the Pallas kernel in interpret
mode), JAX's table kernel differs from the port's plain table pass by
4.2e-5 of max|rad| and 5.2e-5 on tau on this LOS.  The port is not at
fault: the two passes state the same arithmetic, and the gap comes from
how XLA:CPU compiles JAX's kernel body.

* XLA:CPU's LLVM back end contracts ``a * b + c`` into one fused
  multiply-add wherever the host has FMA instructions.  In the row lookup
  (``row_lookup``, ``jurassic_tpu/ops/pallas/ega_fused.py:980-1002``) that
  turns ``u0 * RATIO - u0`` and ``u_lo * RATIO - u_lo`` (the width of the
  bracketing u interval) and ``l2u0 + fk * R6`` (the exponent of ``u_lo``)
  into single roundings; in the recursion it does the same to
  ``1 - tau_gas * exp(-bds)``.  The interval width then differs by up to
  ~5e-7 relative, with the same sign for every segment that stays in one
  bracket, so each segment's emissivity increment is scaled the same way
  and the difference grows linearly along the path (from segment ~179 of
  ray 4 on, channel 1, 832 cm^-1).
* JAX lowers ``exp2(x)`` as ``exp(log(2) * x)`` and ``log2(x)`` as
  ``log(x) / log(2)``; the port (PyTorch on the CPU, libdevice's
  ``exp2f``/``log2f`` in the CUDA kernel) calls the base-2 functions.  At
  the flagship's u ~ 1e16-1e22 (exponents ~55-75) the two ``exp2`` differ
  by up to 2.1e-6 relative.

The port's plain pass and its CUDA kernel (built with ``-fmad=false``)
round every operation on its own, so they stay as they are and the gap is
a known gap of the reference.  The cases below hold it down: with XLA's
FMA contraction switched off (``--xla_cpu_max_isa=SSE4_2``, in a process
of its own, since XLA reads its flags once) the gap falls to 1.3e-6 of
max|rad|, and with XLA's ``exp``/``exp2``/``log``/``log2``/``pow``/
``tanh`` put in for the port's (here, in the test only) the two passes
agree bit for bit: no other operation differs.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
NO_FMA = "--xla_cpu_max_isa=SSE4_2"
NO_FMA_BAR = 2e-6   # rad of max|rad| and tau; measured 1.321e-6 / 8.643e-7
RAYS = 8


def _child() -> None:
    """Print one JSON line: the gaps of the port's table pass to JAX's table
    kernel on one ``ega`` LOS, plain and with XLA's transcendentals, and
    whether this process's XLA contracts multiply-adds."""
    sys.path[:0] = [str(HERE.parent), str(HERE)]
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch
    torch.set_num_threads(1)
    import jurassic_tpu.config as jcfg
    import jurassic_tpu.io_tab as jio
    from jurassic_tpu.forward import ForwardModel as JaxForwardModel
    import jurassic_torch.ops.ega_fused as ef
    from jurassic_torch.forward import ForwardModel
    from jurassic_torch.geometry import los_from_numpy
    from test_torch_host_copies import golden_case

    d = HERE / "goldens" / "ega"
    ctl, obs, atm = golden_case("ega", jcfg, jio, kernel="pallas")
    ctl_t, _, _ = golden_case("ega", kernel="pallas")
    mj = JaxForwardModel(ctl, directory=str(d))
    mt = ForwardModel(ctl_t, directory=str(d), device="cpu")
    # the first eight rays: one ray group of JAX's kernel, and the rays
    # where the gap is largest (ray 4)
    los = jax.tree_util.tree_map(lambda a: a[:RAYS],
                                 mj.trace(atm.copy(), obs.copy()))
    ref = mj.integrate(los)
    rad_j, tau_j = np.asarray(ref.rad), np.asarray(ref.tau)

    def gaps():
        out = mt.integrate(los_from_numpy(los))
        return (float(np.abs(np.asarray(out.rad) - rad_j).max()
                      / np.abs(rad_j).max()),
                float(np.abs(np.asarray(out.tau) - tau_j).max()))

    plain = gaps()
    # the port's transcendentals evaluated by XLA, on whole vectors
    xla = {torch.exp: jnp.exp, torch.log: jnp.log, torch.exp2: jnp.exp2,
           torch.log2: jnp.log2, torch.pow: jnp.power, torch.tanh: jnp.tanh}

    def lanes(fn, *args):
        xs = [a.numpy() for a in torch.broadcast_tensors(*args)]
        n = xs[0].size
        pad = -n % 1024
        flat = [np.concatenate([x.ravel(), np.ones(pad, x.dtype)]) for x in xs]
        out = np.asarray(jax.jit(xla[fn])(*flat))[:n]
        return torch.from_numpy(out.reshape(xs[0].shape).copy())
    ef._lanes = lanes
    with_xla = gaps()

    a, b, c = (np.random.default_rng(0).standard_normal(4096)
               .astype(np.float32) for _ in range(3))
    fused = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    print(json.dumps({"plain": plain, "xla_transcendentals": with_xla,
                      "contracts": bool((fused != a * b + c).any())}))


@pytest.fixture(scope="module")
def gaps():
    """The gaps with XLA's FMA contraction off, from a process of its own
    (about 30 s, most of it XLA compiling JAX's kernel)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["XLA_FLAGS"] = " ".join(
        f for f in (env.get("XLA_FLAGS", ""), NO_FMA) if f)
    proc = subprocess.run([sys.executable, __file__, "--child"], env=env,
                          cwd=HERE.parent, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not res["contracts"], res
    return res


@pytest.mark.parametrize("forms", ["plain", "xla_transcendentals"])
def test_table_pass_matches_jax_without_fma(gaps, forms):
    """With XLA's FMA contraction off the port's plain table pass is
    within 2e-6 of max|rad| and on tau of JAX's table kernel (measured
    1.321e-6 / 8.643e-7: the exp2/log2 forms), and with XLA's
    transcendentals in the port's place the two are bit for bit.  With
    the contraction on (JAX's default on this CPU) the gap is 4.210e-5 /
    5.153e-5 (``tests/jax_table_gap.py``)."""
    rad, tau = gaps[forms]
    if forms == "plain":
        assert rad <= NO_FMA_BAR and tau <= NO_FMA_BAR, gaps
    else:
        assert rad == 0.0 and tau == 0.0, gaps


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    _child()
