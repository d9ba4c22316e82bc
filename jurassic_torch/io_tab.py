"""Atmosphere / observation containers and tab-separated ASCII I/O.

Formats are byte-compatible with the reference writers
(``write_atm`` jurassic.c:1249-1277, ``write_obs`` jurassic.c:1426-1470,
``read_atm`` :882-916, ``read_obs`` :1041-1068): ``#``-prefixed headers,
``%.2f`` times, ``%g`` data fields, blank lines between time blocks.

Unlike the reference's statically-sized structs-of-arrays (atm_t/obs_t,
jurassic.h:215-226/371-385) these containers are runtime-shaped NumPy
arrays in float64.  Copy of ``jurassic_tpu/io_tab.py``, kept identical
in behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from .config import Ctl, NP_MAX, NR_MAX


def _fmt_g(x: float) -> str:
    """C printf %g formatting (Python's %g matches C's for these values)."""
    return "%g" % x


@dataclass
class Atm:
    """Atmospheric state: struct-of-arrays over data points.

    Mirror of atm_t (jurassic.h:215-226): time [s since 2000-01-01T00:00Z],
    z [km], lon/lat [deg], p [hPa], t [K], vmr q[ng] and gray extinction
    k[nw] [1/km].
    """

    time: np.ndarray
    z: np.ndarray
    lon: np.ndarray
    lat: np.ndarray
    p: np.ndarray
    t: np.ndarray
    q: np.ndarray  # [ng, np]
    k: np.ndarray  # [nw, np]

    @property
    def npts(self) -> int:
        return int(self.time.shape[0])

    @classmethod
    def zeros(cls, npts: int, ng: int, nw: int) -> "Atm":
        return cls(
            time=np.zeros(npts), z=np.zeros(npts), lon=np.zeros(npts),
            lat=np.zeros(npts), p=np.zeros(npts), t=np.zeros(npts),
            q=np.zeros((ng, npts)), k=np.zeros((nw, npts)),
        )

    def copy(self) -> "Atm":
        return Atm(*(np.array(getattr(self, f.name)) for f in
                     __import__("dataclasses").fields(Atm)))


@dataclass
class Obs:
    """Observation geometry and radiance data (mirror of obs_t,
    jurassic.h:371-385). rad/tau are [nr, nd], channel-minor."""

    time: np.ndarray
    obsz: np.ndarray
    obslon: np.ndarray
    obslat: np.ndarray
    vpz: np.ndarray
    vplon: np.ndarray
    vplat: np.ndarray
    tpz: np.ndarray
    tplon: np.ndarray
    tplat: np.ndarray
    rad: np.ndarray  # [nr, nd]
    tau: np.ndarray  # [nr, nd]

    @property
    def nr(self) -> int:
        return int(self.time.shape[0])

    @classmethod
    def zeros(cls, nr: int, nd: int) -> "Obs":
        z = lambda: np.zeros(nr)
        return cls(time=z(), obsz=z(), obslon=z(), obslat=z(), vpz=z(),
                   vplon=z(), vplat=z(), tpz=z(), tplon=z(), tplat=z(),
                   rad=np.zeros((nr, nd)), tau=np.zeros((nr, nd)))

    def copy(self) -> "Obs":
        return Obs(*(np.array(getattr(self, f.name)) for f in
                     __import__("dataclasses").fields(Obs)))


def atm_from_fields(fields: dict) -> Atm:
    """An :class:`Atm` from a dict of its fields (array-likes, copied):
    the inverse of ``dataclasses.asdict``, e.g. to carry an atmosphere
    built by the JAX package across without sharing its class."""
    return Atm(**{k: np.array(v, np.float64) for k, v in fields.items()})


def obs_from_fields(fields: dict) -> Obs:
    """An :class:`Obs` from a dict of its fields (array-likes, copied)."""
    return Obs(**{k: np.array(v, np.float64) for k, v in fields.items()})


def read_atm(path: str | Path, ctl: Ctl) -> Atm:
    """Read atmospheric data (read_atm, jurassic.c:882-916).

    Checkmode != 0 validates that the file opens, reports, and skips the
    parse (jurassic.c:892-896)."""
    path = Path(path)
    print(f"Read atmospheric data: {path}")
    if ctl.checkmode:
        with open(path):
            pass                       # existence/permission validation
        print(f"# read_atm can read max {NP_MAX} points")
        print(f"# read_atm found file {path} but skip")
        return Atm.zeros(0, ctl.ng, ctl.nw)
    rows = []
    ncol = 6 + ctl.ng + ctl.nw
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < ncol:
                continue
            try:
                row = [float(t) for t in toks[:ncol]]
            except ValueError:
                continue
            rows.append(row)
    if not rows:
        raise ValueError(f"Could not read any data from {path}!")
    if len(rows) > NP_MAX:
        raise ValueError("Too many data points!")
    a = np.array(rows)
    return Atm(
        time=a[:, 0], z=a[:, 1], lon=a[:, 2], lat=a[:, 3], p=a[:, 4],
        t=a[:, 5],
        q=a[:, 6:6 + ctl.ng].T.copy(),
        k=a[:, 6 + ctl.ng:6 + ctl.ng + ctl.nw].T.copy(),
    )


def write_atm(path: str | Path, ctl: Ctl, atm: Atm) -> None:
    """Write atmospheric data (write_atm, jurassic.c:1249-1277)."""
    path = Path(path)
    if ctl.checkmode:
        print("# skip writing target file name for atmospheric data: "
              f"{path}")
        return
    print(f"Write atmospheric data: {path}")
    with open(path, "w") as out:
        out.write(
            "# $1 = time (seconds since 2000-01-01T00:00Z)\n"
            "# $2 = altitude [km]\n"
            "# $3 = longitude [deg]\n"
            "# $4 = latitude [deg]\n"
            "# $5 = pressure [hPa]\n"
            "# $6 = temperature [K]\n")
        n = 6
        for ig in range(ctl.ng):
            n += 1
            out.write(f"# ${n} = {ctl.emitter[ig]} volume mixing ratio\n")
        for iw in range(ctl.nw):
            n += 1
            out.write(f"# ${n} = window {iw}: extinction [1/km]\n")
        for ip in range(atm.npts):
            if ip == 0 or atm.time[ip] != atm.time[ip - 1]:
                out.write("\n")
            out.write("%.2f %s %s %s %s %s" % (
                atm.time[ip], _fmt_g(atm.z[ip]), _fmt_g(atm.lon[ip]),
                _fmt_g(atm.lat[ip]), _fmt_g(atm.p[ip]), _fmt_g(atm.t[ip])))
            for ig in range(ctl.ng):
                out.write(" " + _fmt_g(atm.q[ig, ip]))
            for iw in range(ctl.nw):
                out.write(" " + _fmt_g(atm.k[iw, ip]))
            out.write("\n")


def read_obs(path: str | Path, ctl: Ctl) -> Obs:
    """Read observation data (read_obs, jurassic.c:1041-1068).

    Checkmode > 0 validates that the file opens, reports, and skips the
    parse; checkmode < 0 ("obs" mode) still reads
    (jurassic.c:1046-1050)."""
    path = Path(path)
    print(f"Read observation data: {path}")
    if ctl.checkmode > 0:
        with open(path):
            pass                       # existence/permission validation
        print(f"# read_obs can read max {NR_MAX} rays")
        print(f"# read_obs found file {path} but skip")
        return Obs.zeros(0, ctl.nd)
    rows = []
    ncol = 10 + 2 * ctl.nd
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < ncol:
                continue
            try:
                row = [float(t) for t in toks[:ncol]]
            except ValueError:
                continue
            rows.append(row)
    if not rows:
        raise ValueError(f"Could not read any data from {path}!")
    if len(rows) > NR_MAX:
        raise ValueError("Too many rays!")
    a = np.array(rows)
    nd = ctl.nd
    return Obs(
        time=a[:, 0], obsz=a[:, 1], obslon=a[:, 2], obslat=a[:, 3],
        vpz=a[:, 4], vplon=a[:, 5], vplat=a[:, 6],
        tpz=a[:, 7], tplon=a[:, 8], tplat=a[:, 9],
        rad=a[:, 10:10 + nd].copy(), tau=a[:, 10 + nd:10 + 2 * nd].copy(),
    )


def write_obs(path: str | Path, ctl: Ctl, obs: Obs) -> None:
    """Write observation data (write_obs, jurassic.c:1426-1470)."""
    path = Path(path)
    if ctl.checkmode:
        print("# skip writing target file name for observation data: "
              f"{path}")
        return
    print(f"Write observation data: {path}")
    with open(path, "w") as out:
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
            "# $10 = tangent point latitude [deg]\n")
        n = 10
        rad_or_bt = ("brightness temperature [K]" if ctl.write_bbt
                     else "radiance [W/(m^2 sr cm^-1)]")
        for idx in range(ctl.nd):
            n += 1
            out.write(f"# ${n} = channel {_fmt_g(ctl.nu[idx])}: {rad_or_bt}\n")
        for idx in range(ctl.nd):
            n += 1
            if ctl.nd < 65 or idx < 1 or idx > ctl.nd - 2:
                out.write(f"# ${n} = channel {_fmt_g(ctl.nu[idx])}: transmittance\n")
            elif idx == 1:
                out.write(f"# ${n} through ${n + ctl.nd - 3} transmittance\n")
        for ir in range(obs.nr):
            if ir == 0 or (NR_MAX > 1 and obs.time[ir] != obs.time[ir - 1]):
                out.write("\n")
            out.write("%.2f %s %s %s %s %s %s %s %s %s" % (
                obs.time[ir],
                _fmt_g(obs.obsz[ir]), _fmt_g(obs.obslon[ir]), _fmt_g(obs.obslat[ir]),
                _fmt_g(obs.vpz[ir]), _fmt_g(obs.vplon[ir]), _fmt_g(obs.vplat[ir]),
                _fmt_g(obs.tpz[ir]), _fmt_g(obs.tplon[ir]), _fmt_g(obs.tplat[ir])))
            for idx in range(ctl.nd):
                out.write(" " + _fmt_g(obs.rad[ir, idx]))
            for idx in range(ctl.nd):
                out.write(" " + _fmt_g(obs.tau[ir, idx]))
            out.write("\n")


def write_matrix(path: str | Path, ctl: Ctl, matrix: np.ndarray,
                 atm: Atm, obs: Obs, rowspace: str = "y",
                 colspace: str = "x", sort: str = "r") -> None:
    """Write a matrix with row/column annotations (write_matrix,
    jurassic.c:1309-1423).

    rowspace/colspace: 'y' = measurement space (finite-radiance cells),
    anything else = state space (retrieval grid points).  sort: 'r' =
    row-major sweep with a blank line per row, else column-major.
    Zero elements are skipped, like the reference."""
    from .retrieval import atm2x, idx2name, obs2y
    path = Path(path)
    if not ctl.write_matrix:
        return
    print(f"Write matrix: {path}")
    with open(path, "w") as out:
        if rowspace[0] == "y":
            out.write(
                "# $1 = Row: index (measurement space)\n"
                "# $2 = Row: channel wavenumber [cm^-1]\n"
                "# $3 = Row: time (seconds since 2000-01-01T00:00Z)\n"
                "# $4 = Row: view point altitude [km]\n"
                "# $5 = Row: view point longitude [deg]\n"
                "# $6 = Row: view point latitude [deg]\n")
            _, rida, rira = obs2y(ctl, obs)
            nr = rida.size

            def row_info(i):
                ir = rira[i]
                return "%d %s %.2f %s %s %s" % (
                    i, _fmt_g(ctl.nu[rida[i]]), obs.time[ir],
                    _fmt_g(obs.vpz[ir]), _fmt_g(obs.vplon[ir]),
                    _fmt_g(obs.vplat[ir]))
        else:
            out.write(
                "# $1 = Row: index (state space)\n"
                "# $2 = Row: name of quantity\n"
                "# $3 = Row: time (seconds since 2000-01-01T00:00Z)\n"
                "# $4 = Row: altitude [km]\n"
                "# $5 = Row: longitude [deg]\n"
                "# $6 = Row: latitude [deg]\n")
            _, riqa, ripa = atm2x(ctl, atm)
            nr = riqa.size

            def row_info(i):
                ip = ripa[i]
                return "%d %s %.2f %s %s %s" % (
                    i, idx2name(ctl, int(riqa[i])), atm.time[ip],
                    _fmt_g(atm.z[ip]), _fmt_g(atm.lon[ip]),
                    _fmt_g(atm.lat[ip]))
        if colspace[0] == "y":
            out.write(
                "# $7 = Col: index (measurement space)\n"
                "# $8 = Col: channel wavenumber [cm^-1]\n"
                "# $9 = Col: time (seconds since 2000-01-01T00:00Z)\n"
                "# $10 = Col: view point altitude [km]\n"
                "# $11 = Col: view point longitude [deg]\n"
                "# $12 = Col: view point latitude [deg]\n")
            _, cida, cira = obs2y(ctl, obs)
            nc = cida.size

            def col_info(j):
                ir = cira[j]
                return "%d %s %.2f %s %s %s" % (
                    j, _fmt_g(ctl.nu[cida[j]]), obs.time[ir],
                    _fmt_g(obs.vpz[ir]), _fmt_g(obs.vplon[ir]),
                    _fmt_g(obs.vplat[ir]))
        else:
            out.write(
                "# $7 = Col: index (state space)\n"
                "# $8 = Col: name of quantity\n"
                "# $9 = Col: time (seconds since 2000-01-01T00:00Z)\n"
                "# $10 = Col: altitude [km]\n"
                "# $11 = Col: longitude [deg]\n"
                "# $12 = Col: latitude [deg]\n")
            _, ciqa, cipa = atm2x(ctl, atm)
            nc = ciqa.size

            def col_info(j):
                ip = cipa[j]
                return "%d %s %.2f %s %s %s" % (
                    j, idx2name(ctl, int(ciqa[j])), atm.time[ip],
                    _fmt_g(atm.z[ip]), _fmt_g(atm.lon[ip]),
                    _fmt_g(atm.lat[ip]))
        out.write("# $13 = Matrix element\n\n")
        if sort[0] == "r":
            for i in range(nr):
                for j in range(nc):
                    if matrix[i, j] != 0:
                        out.write(f"{row_info(i)} {col_info(j)} "
                                  f"{_fmt_g(matrix[i, j])}\n")
                out.write("\n")
        else:
            for j in range(nc):
                for i in range(nr):
                    if matrix[i, j] != 0:
                        out.write(f"{row_info(i)} {col_info(j)} "
                                  f"{_fmt_g(matrix[i, j])}\n")
                out.write("\n")


def read_matrix(path: str | Path, shape: tuple[int, int]) -> np.ndarray:
    """Read a matrix written by :func:`write_matrix` (read_matrix,
    jurassic.c:1025-1038): columns 1 and 7 are row/col indices, column 13
    the value; unset elements are zero."""
    path = Path(path)
    print(f"Read matrix: {path}")
    m = np.zeros(shape)
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 13 and not line.startswith("#"):
                try:
                    i, j, v = int(toks[0]), int(toks[6]), float(toks[12])
                except ValueError:
                    continue
                m[i, j] = v
    return m


def read_shape(path: str | Path,
               checkmode: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Read a 2-column shape function (read_shape, jurassic.c:1134-1150).

    Checkmode validates that the file opens and skips the parse
    (jurassic.c:1138)."""
    path = Path(path)
    print(f"Read shape function: {path}")
    if checkmode:
        with open(path):
            pass                       # existence/permission validation
        print(f"# read_shape found {path}")
        return np.zeros(0), np.zeros(0)
    xs, ys = [], []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                try:
                    x, y = float(toks[0]), float(toks[1])
                except ValueError:
                    continue
                xs.append(x)
                ys.append(y)
    if not xs:
        raise ValueError(f"Could not read any data from {path}!")
    return np.array(xs), np.array(ys)


def read_rfm_spec(path: str | Path):
    """Read an RFM spectrum file (read_rfm_spec, jurassic.c:1107-1131):
    4 header lines, the last holding ``npts nu0 dnu nu1``; radiance
    values whitespace-separated across the remaining lines; wavenumbers
    linear from nu0 to nu1.  Returns (nu, rad)."""
    path = Path(path)
    print(f"Read RFM data: {path}")
    with open(path) as f:
        header = [f.readline() for _ in range(4)]
        if not all(header):
            raise ValueError("Error while reading file header!")
        toks = header[3].split()
        npts, nu0, _dnu, nu1 = (int(toks[0]), float(toks[1]),
                                float(toks[2]), float(toks[3]))
        vals: list[float] = []
        for line in f:
            for tok in line.split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    pass
                if len(vals) >= npts:
                    break
            if len(vals) >= npts:
                break
    if len(vals) != npts:
        raise ValueError("Error while reading RFM data!")
    nu = nu0 + (nu1 - nu0) * np.arange(npts) / max(npts - 1, 1)
    return nu, np.array(vals)


def read_obs_rfm(basename: str, z: float, nu: np.ndarray,
                 f: np.ndarray) -> float:
    """Filter-convolved radiance from an RFM spectrum at tangent
    altitude z (read_obs_rfm, jurassic.c:1071-1104): the spectrum file
    is ``<basename>_<z*1000:05d>.asc`` (or the next millimeter up); the
    filter grid is re-sampled linearly between its end points before
    the convolution, exactly like the reference."""
    n = len(nu)
    path = Path(f"{basename}_{int(z * 1000):05d}.asc")
    if not path.exists():
        path = Path(f"{basename}_{int(z * 1000) + 1:05d}.asc")
    nurfm, rad = read_rfm_spec(path)
    nu2 = np.empty(n)
    nu2[0], nu2[-1] = nu[0], nu[-1]
    i = np.arange(1, max(n - 1, 1))
    nu2[1:n - 1] = nu2[0] + (nu2[n - 1] - nu2[0]) * i / (n - 1.0)
    sel = (nurfm >= nu2[0]) & (nurfm <= nu2[-1])
    idx = np.clip(np.searchsorted(nu2, nurfm[sel], side="right") - 1,
                  0, n - 2)
    filt = f[idx] + (nurfm[sel] - nu2[idx]) / (nu2[idx + 1] - nu2[idx]) \
        * (f[idx + 1] - f[idx])
    fsum = filt.sum()
    return float((filt * rad[sel]).sum() / fsum)


def write_atm_rfm(path: str | Path, ctl: Ctl, atm: Atm) -> None:
    """Write atmospheric data in RFM profile format (write_atm_rfm,
    jurassic.c:1280-1297): point count, then *HGT/*PRE/*TEM blocks and
    one *<EMITTER> [ppmv] block per gas, terminated by *END."""
    path = Path(path)
    print(f"Write RFM data: {path}")
    with open(path, "w") as out:
        out.write(f"{atm.npts}\n")
        for tag, vals in (("HGT [km]", atm.z), ("PRE [mb]", atm.p),
                          ("TEM [K]", atm.t)):
            out.write(f"*{tag}\n")
            for v in vals:
                out.write(_fmt_g(v) + "\n")
        for ig in range(ctl.ng):
            out.write(f"*{ctl.emitter[ig]} [ppmv]\n")
            for v in atm.q[ig]:
                out.write(_fmt_g(v * 1e6) + "\n")
        out.write("*END\n")


def read_atm_rfm(path: str | Path, ctl: Ctl) -> Atm:
    """Read an RFM profile-format atmosphere back (round-trip companion
    of :func:`write_atm_rfm`; the reference ships only the writer).
    Unknown blocks are ignored; gases not present stay zero."""
    path = Path(path)
    print(f"Read RFM data: {path}")
    blocks: dict[str, list[float]] = {}
    cur: list[float] | None = None
    with open(path) as f:
        npts = int(f.readline().split()[0])
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("*"):
                name = line[1:].split()[0].upper()
                if name == "END":
                    break
                cur = blocks.setdefault(name, [])
                continue
            if cur is not None:
                cur.extend(float(t) for t in line.split())
    # a truncated/malformed block must fail HERE with a parse error,
    # not later as an opaque broadcast shape mismatch (ADVICE r4)
    for name, vals in blocks.items():
        if len(vals) < npts:
            raise ValueError(
                f"RFM block *{name} in {path} holds {len(vals)} values "
                f"but the header declares {npts} levels")
    atm = Atm.zeros(npts, ctl.ng, ctl.nw)
    atm.z = np.array(blocks.get("HGT", np.zeros(npts)))[:npts]
    atm.p = np.array(blocks.get("PRE", np.zeros(npts)))[:npts]
    atm.t = np.array(blocks.get("TEM", np.zeros(npts)))[:npts]
    for ig in range(ctl.ng):
        g = ctl.emitter[ig].upper()
        if g in blocks:
            atm.q[ig] = np.array(blocks[g][:npts]) * 1e-6
    return atm
