"""Report memory requirements (mirror of memoryinfo.c:30-45).

Unlike the reference, arrays here are runtime-shaped, so this reports both
the configured capacity limits and — when given a ctl file — the actual
footprint of the tables that configuration loads:

    python -m jurassic_torch.cli.memoryinfo [<ctl> [NAME value ...]]

The port's own copy of ``jurassic_tpu/cli/memoryinfo.py``.
"""
from __future__ import annotations

import sys

from ..config import (ND_MAX, NG_MAX, NLOS_MAX, NP_MAX, NR_MAX, NW_MAX,
                      TBLNP, TBLNS, TBLNT, TBLNU)


def _report_loaded(argv) -> None:
    """Actual loaded-table footprint for a ctl configuration."""
    from ._common import load_ctl
    from ..tables import build_fast_tables, load_tables_cached, table_report
    ctl, _ = load_ctl(argv, 2, "[<ctl>]")
    tbl = load_tables_cached(ctl, ".")
    table_report(ctl, tbl)
    nbytes = sum(a.nbytes for a in tbl)
    print(f"loaded EgaTables footprint: {nbytes / 1e9:.6f} GByte")
    ft = build_fast_tables(tbl)
    fbytes = sum(a.nbytes for a in ft)
    print(f"fast-mode FastTables footprint: {fbytes / 1e9:.6f} GByte "
          f"({100 * fbytes / max(nbytes, 1):.1f} % of exact)")


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    print(f"\njurassic_torch is configured as  ND={ND_MAX}  NG={NG_MAX}  "
          f"NP={NP_MAX}  NR={NR_MAX}  NW={NW_MAX}")
    print(f"   tables are configured as  TBLNP={TBLNP}  TBLNT={TBLNT}  "
          f"TBLNU={TBLNU}")
    print("   table payloads are FP32 (float), axes FP64 (double)")
    print(f"   NLOS={NLOS_MAX}")
    f32, f64 = 4e-9, 8e-9
    tbl_payload = 2 * NG_MAX * TBLNP * TBLNT * TBLNU * ND_MAX * f32
    tbl_axes = NG_MAX * TBLNP * ND_MAX * f64 * (1 + TBLNT * (1 + TBLNU * 0))
    src = TBLNS * ND_MAX * f64
    print(f"emissivity tables (u+eps, dense padded) take {tbl_payload:12.6f} GByte at capacity")
    print(f"table axes take                            {tbl_axes:12.6f} GByte at capacity")
    print(f"source-function table takes                {src:12.6f} GByte at capacity")
    atm = NP_MAX * (6 + NG_MAX + NW_MAX) * f64
    obs = NR_MAX * (10 + 2 * ND_MAX) * f64
    los = NR_MAX * NLOS_MAX * (8 + 2 * NG_MAX + NW_MAX) * f64
    print(f"atm arrays take   {atm * 1e6:12.3f} kByte at capacity")
    print(f"obs arrays take   {obs * 1e3:12.3f} MByte at capacity")
    print(f"LOS arrays take   {los:12.3f} GByte at capacity (fp64 host)")
    if len(argv) > 1:
        _report_loaded(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
