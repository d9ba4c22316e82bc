"""The JAX package's ``kernel_autodiff`` at one flagship ray on the CPU,
in float32 or float64: how many of its entries are not finite.  Not a
test; it answers whether the float32 NaN of a saturated limb path (the
port's ``tests/test_torch_retrieval_f32.py``) is a gap the reference
shares.  float32 runs with ``jax_enable_x64`` off (with it on, the
float32 tracer does not trace: its scan's carry turns float64),
float64 with it on.

    JAX_PLATFORMS=cpu python tests/jax_float32_jacobian.py 32 [RAY [HYDZ]]
    JAX_PLATFORMS=cpu python tests/jax_float32_jacobian.py 64 [RAY [HYDZ]]

RAY defaults to 0 (tangent point 3 km), HYDZ to 20 (the hydrostatic
rebuild in the graph); the state is T at 10 km (n = 1).
"""
import dataclasses
import sys
import time
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv) -> None:
    bits = int(argv[0])
    ray = int(argv[1]) if len(argv) > 1 else 0
    hydz = float(argv[2]) if len(argv) > 2 else 20.0
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", bits == 64)
    import jax.numpy as jnp

    from bench import build_workload
    from jurassic_tpu.forward import ForwardModel
    from jurassic_tpu.io_tab import Obs
    from jurassic_tpu.retrieval import kernel_autodiff
    ctl, ft, atm, obs = build_workload()
    ctl.kernel, ctl.hydz = "jax", hydz
    ctl.rett_zmin = ctl.rett_zmax = 10.0
    obs = Obs(**{f.name: np.asarray(getattr(obs, f.name))[[ray]]
                 for f in dataclasses.fields(Obs)})
    dtype = jnp.float64 if bits == 64 else jnp.float32
    t0 = time.perf_counter()
    K = np.asarray(kernel_autodiff(
        ctl, atm.copy(), obs.copy(),
        ForwardModel(ctl, fast_tables=ft, dtype=dtype)))
    bad = np.flatnonzero(~np.isfinite(K).ravel())
    print(f"ray {ray}, HYDZ {hydz}, float{bits}: K {K.shape}, "
          f"{bad.size} of {K.size} entries not finite (channels "
          f"{bad.tolist()[:8]}{' ...' if bad.size > 8 else ''}); "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
