"""JURASSIC forward model CLI of the port (mirror of formod.c and
``jurassic_tpu/cli/formod.py``).

Usage: ``python -m jurassic_torch.cli.formod <ctl> <obs> <atm> <rad>
[NAME value ...]``

The reference's BENCHMARK_FORMOD block (formod.c:71-181) is available at
run time: ``BENCH 1`` (iterations from ``USEGPU``^2, like the reference's
useGPU^2) or ``BENCH <n>`` repeats formod with the repeat-run deviation
gate before timings are reported (formod.c:106-166); ``BENCH_SCALING 1``
sweeps power-of-2 ray and channel counts (formod.c:84-92) on the loaded
model's tables cut by channel, so no table is read and no turbo fit
runs again.  ``PROFILE <dir>`` writes a torch.profiler trace of model
set-up and the first formod, whose spans (``ForwardModel.phase_log``)
are drawn beside the kernels; it prints the device's idle time over that
call by span and, beside the launch line, the call's split and counts.

The last line reports the device, what the last pass ran (``turbo``,
``table``, ``turbo+hybrid``, or the eager ``exact`` / ``fast``) and the
launches of the two fused kernels over the whole run (0 on the CPU,
where the plain PyTorch versions run).
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from ..forward import ForwardModel, channel_ctl
from ..geometry import hydrostatic_atm
from ..io_tab import read_atm, read_obs, write_obs
from ..ops import ega_fused
from ..tables import tables_checkmode
from ..utils import profile_trace, timer
from ._common import cli_main, load_ctl


def _compare_runs(ctl, obs_ref, obs_bench) -> int:
    """Element-wise repeat-run comparison (formod.c:106-159): per-ray and,
    on deviation, per-channel max-abs reports.  Returns the number of
    deviating views (0 = bitwise reproducible)."""
    rad_or_bt = ("brightness temperature" if ctl.write_bbt else "radiance")
    deviations = 0
    for axis, which in ((1, "ray"), (0, "channel")):
        dev_tau = np.nan_to_num(obs_bench.tau - obs_ref.tau)
        dev_rad = np.nan_to_num(obs_bench.rad - obs_ref.rad)
        ndev_t = np.sum(np.any(dev_tau != 0, axis=axis))
        ndev_r = np.sum(np.any(dev_rad != 0, axis=axis))
        for name, dev, ndev in (("transmittance", dev_tau, ndev_t),
                                (rad_or_bt, dev_rad, ndev_r)):
            per = np.max(np.abs(dev), axis=axis)
            for i in np.nonzero(per)[0]:
                print(f"# deviations in {name} in {which} #{i}, "
                      f"largest {per[i]:.1e}")
        if ndev_t > 0 or ndev_r > 0:
            deviations += 1
        if deviations == 0:
            break  # transposed report only when the first pass deviates
    print(f"# Compare obs-results: {rad_or_bt} and transmittance for "
          f"{obs_ref.nr} rays times {ctl.nd} channels shows"
          f"{'' if deviations else ' no'} deviations")
    return deviations


def _bench_scaling(fm: ForwardModel, atm, obs) -> None:
    """Power-of-2 nr x nd scaling sweep (BENCH_FORMOD_SCALING_TESTS,
    formod.c:84-92)."""
    ctl = fm.ctl
    nd = 1
    while nd <= ctl.nd:
        print(f"# with channels\n# with {nd} channels measure "
              "formod time")
        fm_b = fm.channel_model(channel_ctl(ctl, nd))
        nr = 1
        while nr <= obs.nr:
            obs_b = obs.copy()
            for f in dataclasses.fields(obs_b):
                v = getattr(obs_b, f.name)[:nr]
                setattr(obs_b, f.name, v[:, :nd] if v.ndim > 1 else v)
            print(f"\nscaling test: runs with {nr} rays and {nd} "
                  "channels")
            fm_b.formod(atm.copy(), obs_b)       # warm-up
            t0 = time.perf_counter()
            fm_b.formod(atm.copy(), obs_b)
            dt = time.perf_counter() - t0
            print(f"# with {nr} rays and {nd} channels formod took "
                  f"{dt:g} seconds ({nr * nd / dt:.1f} rays*ch/s)")
            nr *= 2
        nd *= 2


def _bench(fm: ForwardModel, atm, obs, bench: int) -> None:
    """``BENCH`` runs with the repeat-run deviation gate
    (formod.c:94-181)."""
    ctl = fm.ctl
    niter = max(1, ctl.usetpu * ctl.usetpu) if bench == 1 else bench
    if niter > 1:
        print(f"# always run {niter} iterations for benchmarking")
    times = []
    deviations = 0
    for it in range(niter):
        obs_b = obs.copy()
        t0 = time.perf_counter()
        fm.formod(atm, obs_b)
        times.append(time.perf_counter() - t0)
        if it == 0:
            deviations = _compare_runs(ctl, obs, obs_b)
        if deviations:
            break
    if deviations:
        print(f"# timing results are not shown due to deviations "
              f"({deviations}) in obs-results!")
    else:
        mean = float(np.mean(times))
        sigma = float(np.std(times))
        print(f"# with {obs.nr} rays and {ctl.nd} channels formod took "
              f"{mean:g} +/- {sigma:g} seconds")


@cli_main
def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    ctl, s = load_ctl(argv, 5, "<ctl> <obs> <atm> <rad>")
    obs = read_obs(argv[2], ctl)
    atm = read_atm(argv[3], ctl)

    if ctl.checkmode:
        # dry-run validation (jurassic.c:401-413, 654): report the table
        # filename patterns per gas and validate the filter files open
        tables_checkmode(ctl, ".")
        hydrostatic_atm(ctl, atm)
        print(f"# formod: checkmode = {ctl.checkmode}, "
              "no actual computation is performed!")
        write_obs(argv[4], ctl, obs)
        return 0
    n_turbo, n_table = ega_fused.LAUNCHES, ega_fused.LAUNCHES_TABLE
    profile_dir = s.scan("PROFILE", -1, "-")
    with profile_trace(None if profile_dir == "-" else profile_dir):
        # phase timers (TIMER stack, jurassic.c:1224-1246; the reference
        # times table init, jurassic.c:322,417, and warm-up, formod.c:64)
        timer("INIT_MODEL", 1)
        fm = ForwardModel(ctl)
        timer("INIT_MODEL", 3)
        if profile_dir != "-":
            fm.phase_log = []
        timer("WARM-UP", 1)
        fm.formod(atm, obs)
        timer("WARM-UP", 3)
    log, fm.phase_log = fm.phase_log, None
    write_obs(argv[4], ctl, obs)

    if s.scan_int("BENCH_SCALING", -1, "0"):
        _bench_scaling(fm, atm, obs)
    else:
        bench = s.scan_int("BENCH", -1, "0")
        if bench:
            _bench(fm, atm, obs, bench)
    print(f"# formod: device {fm.device}, variant {fm.last_variant}, "
          f"fused EGA kernel launches turbo "
          f"{ega_fused.LAUNCHES - n_turbo} table "
          f"{ega_fused.LAUNCHES_TABLE - n_table}")
    if log:
        print("# formod: warm-up split " + ", ".join(
            f"{k} {v:.2f}" for k, v in log[0].items()) + " ms; counts "
            + ", ".join(f"{k} {v}" for k, v in log[0].counts.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
