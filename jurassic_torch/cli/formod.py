"""JURASSIC forward model CLI of the port (mirror of formod.c and
``jurassic_tpu/cli/formod.py``).

Usage: ``python -m jurassic_torch.cli.formod <ctl> <obs> <atm> <rad>
[NAME value ...]``

Runs the plain forward model once and writes the radiance file.  The
``BENCH``/``BENCH_SCALING`` timing flags of the JAX CLI are not ported
yet.  The last line reports the device, what the fused pass ran
(``turbo``, ``table`` or ``turbo+hybrid``) and the launches of the two
fused kernels (0 on the CPU, where the plain PyTorch versions run).
"""
from __future__ import annotations

import sys

from ..forward import ROADMAP_WAITS, ForwardModel
from ..geometry import hydrostatic_atm
from ..io_tab import read_atm, read_obs, write_obs
from ..ops import ega_fused
from ..tables import tables_checkmode
from ..utils import timer
from ._common import cli_main, load_ctl


@cli_main
def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    ctl, s = load_ctl(argv, 5, "<ctl> <obs> <atm> <rad>")
    for flag in ("BENCH", "BENCH_SCALING"):
        if s.scan_int(flag, -1, "0"):
            raise NotImplementedError(f"{flag} is a later item "
                                      f"({ROADMAP_WAITS})")
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
    timer("INIT_MODEL", 1)
    fm = ForwardModel(ctl)
    timer("INIT_MODEL", 3)
    timer("FORMOD", 1)
    fm.formod(atm, obs)
    timer("FORMOD", 3)
    write_obs(argv[4], ctl, obs)
    print(f"# formod: device {fm.device}, variant {fm.last_variant}, "
          f"fused EGA kernel launches turbo "
          f"{ega_fused.LAUNCHES - n_turbo} table "
          f"{ega_fused.LAUNCHES_TABLE - n_table}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
