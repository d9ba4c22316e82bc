"""Reshape an observation/radiance file into per-ray spectra
(mirror of obs2spec.c).

Usage: ``python -m jurassic_torch.cli.obs2spec <ctl> <obs> <spec.tab>``

The port's own copy of ``jurassic_tpu/cli/obs2spec.py``.
"""
from __future__ import annotations

import sys

from ..io_tab import read_obs
from ._common import cli_main, load_ctl


@cli_main
def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    ctl, _ = load_ctl(argv, 4, "<ctl> <obs> <spec.tab>")
    obs = read_obs(argv[2], ctl)
    print(f"Write spectra: {argv[3]}")
    with open(argv[3], "w") as out:
        out.write(
            "# $1 = time (seconds since 2000-01-01T00:00Z)\n"
            "# $2 = observer altitude [km]\n"
            "# $3 = observer longitude [deg]\n"
            "# $4 = observer latitude [deg]\n"
            "# $5 = view point altitude [km]\n"
            "# $6 = view point longitude [deg]\n"
            "# $7 = view point latitude [deg]\n"
            "# $8 = tangent point altitude [km]\n"
            "# $9 = tangent point longitude [deg]\n"
            "# $10 = tangent point latitude [deg]\n"
            "# $11 = channel frequency [cm^-1]\n"
            "# $12 = channel radiance [W/(m^2 sr cm^-1)]\n")
        for ir in range(obs.nr):
            out.write("\n")
            for idx in range(ctl.nd):
                out.write("%.2f %g %g %g %g %g %g %g %g %g %.4f %g\n" % (
                    obs.time[ir], obs.obsz[ir], obs.obslon[ir],
                    obs.obslat[ir], obs.vpz[ir], obs.vplon[ir],
                    obs.vplat[ir], obs.tpz[ir], obs.tplon[ir],
                    obs.tplat[ir], ctl.nu[idx], obs.rad[ir, idx]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
