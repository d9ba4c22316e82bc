"""Create observation geometry for a nadir sounder (mirror of nadir.c).

Usage: ``python -m jurassic_torch.cli.nadir <ctl> <obs> [NAME value ...]``

The port's own copy of ``jurassic_tpu/cli/nadir.py``.
"""
from __future__ import annotations

import sys

from ..io_tab import write_obs
from ..models.geometry_gen import nadir_geometry
from ._common import cli_main, load_ctl


@cli_main
def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    ctl, s = load_ctl(argv, 3, "<ctl> <obs>")
    obs = nadir_geometry(
        t0=s.scan_float("T0", -1, "0"),
        t1=s.scan_float("T1", -1, "0"),
        dt=s.scan_float("DT", -1, "1"),
        obsz=s.scan_float("OBSZ", -1, "700"),
        lat0=s.scan_float("LAT0", -1, "-8.01"),
        lat1=s.scan_float("LAT1", -1, "8.01"),
        dlat=s.scan_float("DLAT", -1, "0.18"),
        nd=ctl.nd,
    )
    write_obs(argv[2], ctl, obs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
