"""Control-file / flag system.

Drop-in compatible with the reference ctl grammar (``scan_ctl``,
jurassic.c:1153-1201, and ``read_ctl``, jurassic.c:920-1022):

* a ctl file contains ``NAME = value`` lines (the middle token is arbitrary;
  the scanner reads the first and third whitespace-separated tokens);
* array-valued flags use indexed names ``NAME[3]``; ``NAME[*]`` acts as a
  wildcard matching every index;
* any flag can be overridden by appending ``NAME value`` pairs to the argv
  list (as in ``formod limb.ctl obs.tab atm.tab rad.tab CHECKMODE 1``);
* names are case-insensitive and every flag has a default.

The result is a :class:`Ctl` dataclass holding the full forward-model
configuration.  The accelerator knobs (device selection, kernel mode,
sharding) live here too; ``USEGPU`` is the reference's name and
``USETPU`` the JAX package's, and both set the same field.

Copy of ``jurassic_tpu/config.py``, kept identical in behaviour: the
field is still called ``usetpu`` so that one ctl dict builds either
package's ``Ctl``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

# Capacity limits. Unlike the reference (static C arrays, jurassic.h:137-187)
# our arrays are runtime-shaped; these bounds exist only for input validation
# and for reporting compatible "memoryinfo" numbers.
ND_MAX = 100      # radiance channels
NG_MAX = 30       # emitters
NP_MAX = 9600     # atmospheric data points
NR_MAX = 1088     # ray paths
NW_MAX = 1        # spectral windows
NLOS_MAX = 400    # line-of-sight points per ray
NSHAPE_MAX = 2048  # shape-function grid points
NFOV = 5          # neighbouring pencil beams for FOV convolution
TBLNP = 40        # pressure levels in emissivity tables
TBLNT = 30        # temperatures in emissivity tables
TBLNU = 304       # column densities in emissivity tables
TBLNS = 1201      # source-function temperature levels


class CtlError(ValueError):
    pass


class CtlScanner:
    """Implements the reference's ctl-file + argv-override lookup."""

    def __init__(self, argv: Sequence[str]):
        # argv mirrors C argv: argv[0] program name, argv[1] ctl file path
        # (or "-" for none), overrides may appear anywhere after argv[1].
        self.argv = list(argv)
        self.entries: List[tuple[str, str]] = []
        self.verbose = True
        if len(self.argv) > 1 and not self.argv[1].startswith("-"):
            path = Path(self.argv[1])
            if not path.exists():
                raise CtlError(f"Cannot open ctl file: {path}")
            for line in path.read_text().splitlines():
                toks = line.split()
                if len(toks) >= 3:
                    self.entries.append((toks[0].lower(), toks[2]))

    def scan(self, name: str, arridx: int = -1, default: Optional[str] = None) -> str:
        if arridx >= 0:
            full1, full2 = f"{name}[{arridx}]".lower(), f"{name}[*]".lower()
        else:
            full1 = full2 = name.lower()
        value = None
        for key, val in self.entries:
            if key == full1 or key == full2:
                value = val
                break
        # argv overrides win over file entries (reference checks argv last and
        # overwrites rval, jurassic.c:1178-1185)
        for i in range(1, len(self.argv) - 1):
            if self.argv[i].lower() in (full1, full2):
                value = self.argv[i + 1]
                break
        if value is None:
            if default is not None and default != "":
                value = default
            elif default == "":
                value = ""
            else:
                raise CtlError(f"Missing variable {name}!")
        if self.verbose and arridx < 0:
            print(f"{name} = {value}")
        return value

    def scan_float(self, name: str, arridx: int = -1, default: Optional[str] = None) -> float:
        v = self.scan(name, arridx, default)
        try:
            return float(v)
        except ValueError:
            return 0.0

    def scan_int(self, name: str, arridx: int = -1, default: Optional[str] = None) -> int:
        return int(self.scan_float(name, arridx, default))


@dataclass
class Ctl:
    """Forward-model control parameters (mirror of ctl_t, jurassic.h:229-347)."""

    # Emitters
    ng: int = 0
    emitter: List[str] = field(default_factory=list)
    # Radiance channels
    nd: int = 0
    nu: List[float] = field(default_factory=list)
    # Spectral windows
    nw: int = 1
    window: List[int] = field(default_factory=list)
    # Emissivity look-up tables
    tblbase: str = "-"
    # Hydrostatic equilibrium reference height [km] (-999 to skip)
    hydz: float = -999.0
    # Continua switches
    ctm_co2: int = 1
    ctm_h2o: int = 1
    ctm_n2: int = 1
    ctm_o2: int = 1
    # Interpolation of atmospheric data (1=profile, 2=track, 3=Lagrangian)
    ip: int = 1
    cz: float = 0.0
    cx: float = 0.0
    # Ray-tracing
    refrac: int = 1
    rayds: float = 10.0
    raydz: float = 0.5
    # Field of view
    fov: str = "-"
    # Retrieval interface altitude ranges
    retp_zmin: float = -999.0
    retp_zmax: float = -999.0
    rett_zmin: float = -999.0
    rett_zmax: float = -999.0
    retq_zmin: List[float] = field(default_factory=list)
    retq_zmax: List[float] = field(default_factory=list)
    retk_zmin: List[float] = field(default_factory=list)
    retk_zmax: List[float] = field(default_factory=list)
    # Output
    write_bbt: int = 0
    write_matrix: int = 0
    # Forward model selector (1=CGA, 2=EGA, 3=RFM)
    formod: int = 2
    rfmbin: str = "-"
    rfmhit: str = "-"
    rfmxsc: List[str] = field(default_factory=list)
    # Accelerator (reference: useGPU; here: use the CUDA device,
    # ``device.resolve_device``)
    usetpu: int = -1
    # Dry-run mode
    checkmode: int = 0
    # MPI-era rank info (kept for ctl compatibility; device selection is
    # not taken from them)
    mpi_glob_rank: int = 0
    mpi_local_rank: int = 0
    # Binary table cache
    read_binary: int = -1
    write_binary: int = 1
    # Accelerator execution knobs (no reference equivalent)
    kernel: str = "auto"   # auto | jax | pallas | turbo | exact
    nlos: int = NLOS_MAX   # LOS points budget per ray (static shape)
    raypack: int = 0       # rays per pipelined package; the
                           # stream/package overlap analogue
                           # (GPUdrivers.cu:176-183, 296-335).
                           # 0 (default): auto-size from device memory
                           # (the reference's 90%-of-free lane sizing,
                           # GPUdrivers.cu:296-321); > 0: explicit
                           # package size; < 0: force one monolithic
                           # batch (matches ForwardModel._resolve_raypack)
    early_exit: int = 0    # Pallas kernel: stop the LOS loop once all
                           # lanes are opacity-frozen (exact; wins on
                           # opaque-limb scans, costs a few % of
                           # pipelining on transparent ones)

    def emitter_index(self, name: str) -> int:
        """find_emitter (jurassic.c:198-207): case-insensitive, -1 if absent."""
        for ig, em in enumerate(self.emitter):
            if em.lower() == name.lower():
                return ig
        return -1

    @property
    def table_hash(self) -> str:
        """Key for the binary table cache (analogue of the reference's header
        dims check, jr_binary_tables_io.h:65-211)."""
        key = "|".join(
            [self.tblbase]
            + [f"{e}" for e in self.emitter[: self.ng]]
            + [f"{x:.4f}" for x in self.nu[: self.nd]]
        )
        return hashlib.sha256(key.encode()).hexdigest()[:16]


def read_ctl(argv: Sequence[str], verbose: bool = True) -> Ctl:
    """Parse a ctl file + argv overrides into a :class:`Ctl`.

    Mirrors read_ctl (jurassic.c:920-1022) including the automatic disabling
    of continua whose bands contain no requested channel
    (jurassic.c:954-968).
    """
    s = CtlScanner(argv)
    s.verbose = verbose
    ctl = Ctl()

    ctl.ng = s.scan_int("NG", -1, "0")
    if not 0 <= ctl.ng <= NG_MAX:
        raise CtlError(f"Set 0 <= NG <= {NG_MAX}")
    ctl.emitter = [s.scan("EMITTER", ig, "") for ig in range(ctl.ng)]

    ctl.nd = s.scan_int("ND", -1, "0")
    if not 0 <= ctl.nd <= ND_MAX:
        raise CtlError(f"Set 0 <= ND <= {ND_MAX}")
    ctl.nu = [s.scan_float("NU", idx, "") for idx in range(ctl.nd)]

    ctl.nw = s.scan_int("NW", -1, "1")
    if not 0 <= ctl.nw <= NW_MAX:
        raise CtlError(f"Set 0 <= NW <= {NW_MAX}")
    ctl.window = [s.scan_int("WINDOW", idx, "0") for idx in range(ctl.nd)]

    ctl.tblbase = s.scan("TBLBASE", -1, "-")
    ctl.hydz = s.scan_float("HYDZ", -1, "-999")

    ctl.ctm_co2 = s.scan_int("CTM_CO2", -1, "1")
    ctl.ctm_h2o = s.scan_int("CTM_H2O", -1, "1")
    ctl.ctm_n2 = s.scan_int("CTM_N2", -1, "1")
    ctl.ctm_o2 = s.scan_int("CTM_O2", -1, "1")
    # Disable continua that no channel can see (jurassic.c:954-968)
    in_co2 = sum(nu < 4000 for nu in ctl.nu)
    in_h2o = sum(nu < 20000 for nu in ctl.nu)
    in_n2 = sum(2120 <= nu <= 2605 for nu in ctl.nu)
    in_o2 = sum(1360 <= nu <= 1805 for nu in ctl.nu)
    if in_co2 == 0 and ctl.ctm_co2:
        ctl.ctm_co2 = 0
        if verbose:
            print("No frequency in CO2 range, automatically set CTM_CO2 = 0")
    if in_h2o == 0 and ctl.ctm_h2o:
        ctl.ctm_h2o = 0
        if verbose:
            print("No frequency in H2O range, automatically set CTM_H2O = 0")
    if in_n2 == 0 and ctl.ctm_n2:
        ctl.ctm_n2 = 0
        if verbose:
            print("No frequency in N2 range, automatically set CTM_N2 = 0")
    if in_o2 == 0 and ctl.ctm_o2:
        ctl.ctm_o2 = 0
        if verbose:
            print("No frequency in O2 range, automatically set CTM_O2 = 0")

    ctl.ip = s.scan_int("IP", -1, "1")
    ctl.cz = s.scan_float("CZ", -1, "0")
    ctl.cx = s.scan_float("CX", -1, "0")

    ctl.refrac = s.scan_int("REFRAC", -1, "1")
    ctl.rayds = s.scan_float("RAYDS", -1, "10")
    ctl.raydz = s.scan_float("RAYDZ", -1, "0.5")

    ctl.fov = s.scan("FOV", -1, "-")

    ctl.retp_zmin = s.scan_float("RETP_ZMIN", -1, "-999")
    ctl.retp_zmax = s.scan_float("RETP_ZMAX", -1, "-999")
    ctl.rett_zmin = s.scan_float("RETT_ZMIN", -1, "-999")
    ctl.rett_zmax = s.scan_float("RETT_ZMAX", -1, "-999")
    ctl.retq_zmin = [s.scan_float("RETQ_ZMIN", ig, "-999") for ig in range(ctl.ng)]
    ctl.retq_zmax = [s.scan_float("RETQ_ZMAX", ig, "-999") for ig in range(ctl.ng)]
    ctl.retk_zmin = [s.scan_float("RETK_ZMIN", iw, "-999") for iw in range(ctl.nw)]
    ctl.retk_zmax = [s.scan_float("RETK_ZMAX", iw, "-999") for iw in range(ctl.nw)]

    ctl.write_bbt = s.scan_int("WRITE_BBT", -1, "0")
    ctl.write_matrix = s.scan_int("WRITE_MATRIX", -1, "0")

    ctl.formod = s.scan_int("FORMOD", -1, "2")
    ctl.rfmbin = s.scan("RFMBIN", -1, "-")
    ctl.rfmhit = s.scan("RFMHIT", -1, "-")
    ctl.rfmxsc = [s.scan("RFMXSC", ig, "-") for ig in range(ctl.ng)]

    # USETPU with USEGPU accepted as alias for drop-in ctl files
    usegpu = s.scan_int("USEGPU", -1, "-999")
    ctl.usetpu = s.scan_int("USETPU", -1, str(usegpu if usegpu != -999 else -1))

    ctl.checkmode = s.scan_int("CHECKMODE", -1, "0")
    if verbose:
        mode = "run" if ctl.checkmode == 0 else ("skip" if ctl.checkmode > 0 else "obs")
        print(f"CHECKMODE = {ctl.checkmode} ({mode})")

    ctl.read_binary = s.scan_int("READ_BINARY", -1, "-1")
    ctl.write_binary = s.scan_int("WRITE_BINARY", -1, "1")

    ctl.kernel = s.scan("KERNEL", -1, "auto").lower()
    ctl.nlos = s.scan_int("NLOS", -1, str(NLOS_MAX))
    ctl.raypack = s.scan_int("RAYPACK", -1, "0")
    ctl.early_exit = s.scan_int("EARLY_EXIT", -1, "0")
    return ctl


def ctl_from_dict(d: dict) -> Ctl:
    """Build a Ctl programmatically (tests, library users)."""
    ctl = Ctl()
    for k, v in d.items():
        if not hasattr(ctl, k):
            raise CtlError(f"Unknown ctl field {k}")
        setattr(ctl, k, v)
    ctl.ng = len(ctl.emitter) if ctl.emitter else ctl.ng
    ctl.nd = len(ctl.nu) if ctl.nu else ctl.nd
    if not ctl.window:
        ctl.window = [0] * ctl.nd
    if not ctl.retq_zmin:
        ctl.retq_zmin = [-999.0] * ctl.ng
        ctl.retq_zmax = [-999.0] * ctl.ng
    if not ctl.retk_zmin:
        ctl.retk_zmin = [-999.0] * ctl.nw
        ctl.retk_zmax = [-999.0] * ctl.nw
    return ctl


def ctl_from_fields(fields: dict) -> Ctl:
    """A :class:`Ctl` from a dict of ALL its fields, taken as they are
    (no derived defaults, unlike :func:`ctl_from_dict`): the inverse of
    ``dataclasses.asdict``, e.g. to carry a configuration built by the
    JAX package across without sharing its class."""
    names = {f.name for f in dataclasses.fields(Ctl)}
    unknown = set(fields) - names
    if unknown:
        raise CtlError(f"Unknown ctl fields {sorted(unknown)}")
    return Ctl(**{k: (list(v) if isinstance(v, (list, tuple)) else v)
                  for k, v in fields.items()})
