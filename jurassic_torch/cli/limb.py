"""Create observation geometry for a limb sounder (mirror of limb.c).

Usage: ``python -m jurassic_torch.cli.limb <ctl> <obs> [NAME value ...]``

The port's own copy of ``jurassic_tpu/cli/limb.py``.
"""
from __future__ import annotations

import sys

from ..io_tab import write_obs
from ..models.geometry_gen import limb_geometry
from ._common import cli_main, load_ctl


@cli_main
def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    ctl, s = load_ctl(argv, 3, "<ctl> <obs>")
    obs = limb_geometry(
        t0=s.scan_float("T0", -1, "0"),
        t1=s.scan_float("T1", -1, "0"),
        dt=s.scan_float("DT", -1, "1"),
        obsz=s.scan_float("OBSZ", -1, "780"),
        z0=s.scan_float("Z0", -1, "3"),
        z1=s.scan_float("Z1", -1, "68"),
        dz=s.scan_float("DZ", -1, "1"),
        nd=ctl.nd,
    )
    write_obs(argv[2], ctl, obs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
