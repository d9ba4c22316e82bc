"""The port's table-mode pass against the JAX package's table kernel on a
golden, on the CPU: the largest differences of rad (of max|rad|) and
tau, once on one JAX-traced LOS fed to both passes and once for the two
packages' full ``formod``.  Not a test; it measures the gap that
``tests/test_torch_distributed.py`` carries through the channel split.

    JAX_PLATFORMS=cpu python tests/jax_table_gap.py [CASE]

CASE defaults to ``ega``.
"""
import sys
from pathlib import Path

import jax
import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def main(argv) -> None:
    case = argv[0] if argv else "ega"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jurassic_tpu.config as jcfg
    import jurassic_tpu.io_tab as jio
    from jurassic_tpu.forward import ForwardModel as JaxForwardModel
    from jurassic_torch.forward import ForwardModel
    from jurassic_torch.geometry import los_from_numpy
    from test_torch_host_copies import golden_case

    d = HERE / "goldens" / case
    ctl, obs, atm = golden_case(case, jcfg, jio, kernel="pallas")
    ctl_t, obs_t, atm_t = golden_case(case, kernel="pallas")
    mj = JaxForwardModel(ctl, directory=str(d))
    mt = ForwardModel(ctl_t, directory=str(d), device="cpu")
    los = mj.trace(atm.copy(), obs.copy())
    pairs = {"one LOS": (mt.integrate(los_from_numpy(los)),
                         mj.integrate(los)),
             "formod": (mt.formod(atm_t, obs_t), mj.formod(atm, obs))}
    for name, (t, j) in pairs.items():
        rad_t, tau_t = np.asarray(t.rad), np.asarray(t.tau)
        rad_j, tau_j = np.asarray(j.rad), np.asarray(j.tau)
        scale = np.abs(rad_j).max()
        print(f"{case}, table mode, {name}: rad "
              f"{np.abs(rad_t - rad_j).max() / scale:.3e} of max|rad|, "
              f"tau {np.abs(tau_t - tau_j).max():.3e}")


if __name__ == "__main__":
    main(sys.argv[1:])
