"""Emissivity-growth look-up tables: ASCII parser, padded dense arrays,
binary cache, source-function table, and fast-mode (log-uniform) resampling.

Data model mirrors tbl_t (jurassic.h:387-425) with runtime shapes instead of
compile-time maxima: ragged per-(gas,channel) tables stored in dense padded
arrays with explicit count arrays, channel index minor-most (the
reference's coalesced channel-minor layout, jurassic.h:408-411).
Copy of ``jurassic_tpu/tables.py``, kept identical in behaviour.

The ASCII format (init_tbl, jurassic.c:311-416): one file per
(gas, channel) named ``<tblbase>_<nu:.4f>_<gas>.tab`` of 4-column rows
``pressure temperature column-density emissivity``; new pressure level on
press change, new temperature on temp change, new u entry only when both
eps and u increase monotonically (otherwise the previous entry is
overwritten, replicating jurassic.c:369-384).

Fast mode: the reference's FAST_INVERSE_OF_U (jurassic.c:487-609) documents
that the u grids are geometric with ratio 2^(1/6); we legitimize this by
resampling each u-column onto an exact log-uniform grid at load time and
precomputing the inverse mapping u(tau_od) on a log-uniform optical-depth
grid, so all in-kernel searches collapse to index arithmetic.
"""
from __future__ import annotations

import hashlib
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from .config import Ctl, TBLNP, TBLNS, TBLNT, TBLNU
from .io_tab import read_shape
from .ops.planck import source_table_from_filter, source_temperature_axis


class EgaTables(NamedTuple):
    """Padded dense EGA tables + counts. Axes: [G, P, T, U, D]."""

    np_: np.ndarray   # [G, D] int32 pressure-level counts
    nt: np.ndarray    # [G, P, D] int32 temperature counts
    nu: np.ndarray    # [G, P, T, D] int32 column-density counts
    p: np.ndarray     # [G, P, D] f64 pressure axis [hPa]
    t: np.ndarray     # [G, P, T, D] f64 temperature axis [K]
    u: np.ndarray     # [G, P, T, U, D] f32 column density [molec/cm^2]
    eps: np.ndarray   # [G, P, T, U, D] f32 emissivity
    sr: np.ndarray    # [S, D] f64 source radiance
    st: np.ndarray    # [S] f64 source temperature axis


class FastTables(NamedTuple):
    """Fast-mode resampled tables: u-axis positions are index arithmetic.

    eps is resampled onto exact log-uniform u grids u_k = u0 * 2^(k/6)
    (per gas/p/t/channel u0).  The u payload disappears entirely — u
    values are reconstructed analytically from (log2_u0, k) — so the
    table footprint is HALF the reference's u+eps pair
    (jurassic.h:404-411).  The eps->u inversion (get_u,
    jr_common.h:180-185) stays a binary search on the eps row, exactly
    like the reference; only the u-axis search of get_eps collapses to
    log2 arithmetic (the legitimized FAST_INVERSE_OF_U,
    jurassic.c:487-609).
    """

    np_: np.ndarray        # [G, D] int32
    nt: np.ndarray         # [G, P, D] int32
    p: np.ndarray          # [G, P, D]
    t: np.ndarray          # [G, P, T, D]
    nu: np.ndarray         # [G, P, T, D] int32 (resampled grid length)
    log2_u0: np.ndarray    # [G, P, T, D] log2 of first u grid point
    eps: np.ndarray        # [G, P, T, K, D] f32 on log-uniform u grid
    valid: np.ndarray      # [G, P, T, D] bool corner has a usable table
    sr: np.ndarray         # [S, D]
    st: np.ndarray


def ega_tables_from_fields(fields: dict) -> EgaTables:
    """:class:`EgaTables` from a dict of its fields (array-likes, copied,
    dtypes kept): the inverse of ``_asdict()``, e.g. to carry tables
    loaded by the JAX package across without sharing its class."""
    return EgaTables(**{k: np.array(v) for k, v in fields.items()})


def fast_tables_from_fields(fields: dict) -> FastTables:
    """:class:`FastTables` from a dict of its fields (array-likes,
    copied, dtypes kept)."""
    return FastTables(**{k: np.array(v) for k, v in fields.items()})


def table_filename(tblbase: str, nu: float, gas: str) -> Path:
    """<tblbase>_<nu:.4f>_<gas>.tab (jurassic.c:337)."""
    return Path(f"{tblbase}_{nu:.4f}_{gas}.tab")


def filter_filename(tblbase: str, nu: float) -> Path:
    """<tblbase>_<nu:.4f>.filt (jurassic.c:651)."""
    return Path(f"{tblbase}_{nu:.4f}.filt")


def _parse_tab_file(path: Path):
    """Parse one 4-column LUT file into ragged nested lists, replicating the
    index-advance rules of init_tbl (jurassic.c:355-394) including the
    overwrite of non-monotone entries."""
    press_blocks = []  # [(press, [(temp, [(u, eps), ...]), ...])]
    press_old = temp_old = u_old = eps_old = -999.0
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 4:
                continue
            try:
                press, temp, u, eps = (float(toks[0]), float(toks[1]),
                                       float(toks[2]), float(toks[3]))
            except ValueError:
                continue
            if press != press_old:
                press_old = press
                press_blocks.append((press, []))
                temp_old = -999.0
            tblocks = press_blocks[-1][1]
            if temp != temp_old:
                temp_old = temp
                tblocks.append((temp, []))
            ublock = tblocks[-1][1]
            if (eps > eps_old and u > u_old) or not ublock:
                eps_old, u_old = eps, u
                ublock.append((u, eps))
            else:
                # non-monotone entry overwrites the last one
                # (IDX_U unchanged, store still executed)
                ublock[-1] = (u, eps)
    return press_blocks


def tables_checkmode(ctl: Ctl, directory: str | Path = ".") -> None:
    """Checkmode table validation (init_tbl, jurassic.c:401-413 +
    read_shape, jurassic.c:654): print the filename pattern each gas
    would be initialized from, and validate the per-channel filter
    files open without parsing anything."""
    directory = Path(directory)
    for ig in range(ctl.ng):
        pattern = f"{ctl.tblbase}_<nu.4>_{ctl.emitter[ig]}.tab"
        print(f"# try to initialize tables for gas {ig} "
              f"{ctl.emitter[ig]} from filenames {pattern}")
    print(f"# tables are runtime-shaped; reference capacity would be "
          f"table[{ctl.ng} g][{TBLNP} p][{TBLNT} T][{TBLNU} u]"
          f"[{ctl.nd} nu]")
    for idx in range(ctl.nd):
        fn = directory / filter_filename(ctl.tblbase, ctl.nu[idx])
        read_shape(fn, checkmode=1)


def table_report(ctl: Ctl, tbl: EgaTables) -> None:
    """Table occupancy / minimal-dimension advisory / memory projection
    (the 'jurassic.h could be configured minimally' block,
    jurassic.c:429-484)."""
    G, P, T, U, D = tbl.u.shape
    np_max = int(tbl.np_.max()) if tbl.np_.size else 0
    if np_max == 0:
        print("# no emissivity tables loaded; skipping table report")
        return
    g_p, d_p = np.unravel_index(int(tbl.np_.argmax()), tbl.np_.shape)
    nt_max = int(tbl.nt.max())
    g_t, p_t, d_t = np.unravel_index(int(tbl.nt.argmax()), tbl.nt.shape)
    nu_max = int(tbl.nu.max())
    g_u, p_u, t_u, d_u = np.unravel_index(int(tbl.nu.argmax()),
                                          tbl.nu.shape)
    mem_used = int(tbl.nu.sum(dtype=np.int64))

    from .config import ND_MAX, NG_MAX
    print("\n# tables could be configured minimally with")
    print(f"# NG = {ctl.ng}  \t capacity {NG_MAX}")
    print(f"# ND = {ctl.nd}  \t capacity {ND_MAX}")
    print(f"# TBLNP = {np_max}  \t reference {TBLNP} \t"
          f"(gas[{g_p}]={ctl.emitter[g_p]}  nu[{d_p}]={ctl.nu[d_p]:.4f})")
    print(f"# TBLNT = {nt_max}  \t reference {TBLNT} \t"
          f"(gas[{g_t}]={ctl.emitter[g_t]}  nu[{d_t}]={ctl.nu[d_t]:.4f}  "
          f"pressure[{p_t}]={tbl.p[g_t, p_t, d_t]:.2e})")
    print(f"# TBLNU = {nu_max}  \t reference {TBLNU} \t"
          f"(gas[{g_u}]={ctl.emitter[g_u]}  nu[{d_u}]={ctl.nu[d_u]:.4f}  "
          f"pressure[{p_u}]={tbl.p[g_u, p_u, d_u]:.2e}  "
          f"temperature[{t_u}]={tbl.t[g_u, p_u, t_u, d_u]:g})")
    f = 1e-9 * tbl.u.itemsize * 2             # u + eps payload pair
    dense = G * P * f * T * U * D
    ref_cap = ctl.ng * TBLNP * f * TBLNT * TBLNU * ctl.nd
    sparse = f * mem_used
    print(f"# dense padded table arrays (u + eps) consume "
          f"{dense:.6f} GByte")
    print(f"# reference-capacity arrays would consume {ref_cap:.6f} GByte")
    print(f"# with sparse storage only {sparse:.6f} GByte "
          f"({100 * sparse / max(dense, 1e-30):.1f} %)\n")


def _blocks_to_dense(blocks) -> dict:
    """Nested ragged blocks (Python parser) -> the dense per-file dict
    format of native.parse_tab_file."""
    P = len(blocks)
    T = max((len(tb) for _, tb in blocks), default=1)
    U = max((len(ub) for _, tb in blocks for _, ub in tb), default=1)
    out = {"np": P, "nt": np.zeros(P, np.int32),
           "nu": np.zeros((P, T), np.int32), "p": np.zeros(P),
           "t": np.zeros((P, T)), "u": np.zeros((P, T, U), np.float32),
           "eps": np.zeros((P, T, U), np.float32)}
    for ip, (press, tb) in enumerate(blocks):
        out["p"][ip] = press
        out["nt"][ip] = len(tb)
        for it, (temp, ub) in enumerate(tb):
            out["t"][ip, it] = temp
            out["nu"][ip, it] = len(ub)
            arr = np.array(ub)
            out["u"][ip, it, :len(ub)] = arr[:, 0]
            out["eps"][ip, it, :len(ub)] = arr[:, 1]
    return out


def load_tables(ctl: Ctl, directory: str | Path = ".",
                verbose: bool = True) -> EgaTables:
    """Load all (gas, channel) LUTs + filter functions into padded arrays.

    Missing table files leave np_[g,d] = 0 -> the gas is transparent for
    that channel (ega_eps returns 1, jr_common.h:240-246).

    The parse runs on the native C parser over a thread pool when
    available (native/tabparse.c — the analogue of the
    reference's OpenMP-parallel init_tbl, jurassic.c:311-416, :329),
    falling back to the pure-Python parser otherwise."""
    from . import native
    directory = Path(directory)
    G, D = ctl.ng, ctl.nd
    present = []
    missing = 0
    for ig in range(G):
        for idx in range(D):
            fn = directory / table_filename(ctl.tblbase, ctl.nu[idx],
                                            ctl.emitter[ig])
            if fn.exists():
                present.append((ig, idx, fn))
            else:
                missing += 1
    parsed = native.parse_tab_files([fn for _, _, fn in present])
    dense = {}
    maxP = maxT = maxU = 1
    for (ig, idx, fn), d in zip(present, parsed):
        if d is None:                        # no native library
            blocks = _parse_tab_file(fn)
            if not blocks:
                continue
            d = _blocks_to_dense(blocks)
        if d["np"] <= 0:
            continue
        dense[(ig, idx)] = d
        maxP = max(maxP, d["np"])
        maxT = max(maxT, int(d["nt"].max(initial=0)))
        maxU = max(maxU, int(d["nu"].max(initial=0)))
    if verbose and missing:
        print(f"Warning! {missing} emissivity table files were not found!")
    if maxP > TBLNP or maxT > TBLNT or maxU > TBLNU:
        print(f"Warning! table dims ({maxP},{maxT},{maxU}) exceed reference "
              f"capacity ({TBLNP},{TBLNT},{TBLNU})")

    P, T, U = maxP, maxT, maxU
    np_ = np.zeros((G, D), np.int32)
    nt = np.zeros((G, P, D), np.int32)
    nu_ = np.zeros((G, P, T, D), np.int32)
    p = np.zeros((G, P, D))
    t = np.zeros((G, P, T, D))
    u = np.zeros((G, P, T, U, D), np.float32)
    eps = np.zeros((G, P, T, U, D), np.float32)
    for (ig, idx), d in dense.items():
        fp, ft_, fu = d["p"].size, d["t"].shape[1], d["u"].shape[2]
        np_[ig, idx] = d["np"]
        nt[ig, :fp, idx] = d["nt"]
        nu_[ig, :fp, :ft_, idx] = d["nu"]
        p[ig, :fp, idx] = d["p"]
        t[ig, :fp, :ft_, idx] = d["t"]
        u[ig, :fp, :ft_, :fu, idx] = d["u"]
        eps[ig, :fp, :ft_, :fu, idx] = d["eps"]

    sr, st = load_source_table(ctl, directory)
    tbl = EgaTables(np_=np_, nt=nt, nu=nu_, p=p, t=t, u=u, eps=eps,
                    sr=sr, st=st)
    if verbose:
        table_report(ctl, tbl)
    return tbl


def load_source_table(ctl: Ctl, directory: str | Path = "."):
    """Planck source-function table from per-channel filter files
    (init_tbl, jurassic.c:612-667)."""
    directory = Path(directory)
    st = source_temperature_axis(TBLNS)
    sr = np.zeros((TBLNS, ctl.nd))
    for idx in range(ctl.nd):
        fn = directory / filter_filename(ctl.tblbase, ctl.nu[idx])
        nu_f, f_f = read_shape(fn)
        sr[:, idx] = source_table_from_filter(nu_f, f_f, TBLNS)
    return sr, st


# ---------------------------------------------------------------------------
# Binary cache (analogue of jr_binary_tables_io.h:12-290): a single npz
# keyed by a config hash replaces the reference's self-describing header.

def cache_filename(ctl: Ctl, directory: str | Path = ".") -> Path:
    """Cache file keyed by config identity AND source-file freshness.

    The reference's header check revalidates dims on load
    (jr_binary_tables_io.h:65-211) but would serve stale payloads for
    regenerated same-named tables; here the key folds in each table
    file's (size, mtime) so a regenerated table can never hit a stale
    cache."""
    import hashlib
    stats = []
    for idx in range(ctl.nd):
        for gas in ctl.emitter[:ctl.ng]:
            fn = Path(directory) / table_filename(ctl.tblbase, ctl.nu[idx],
                                                  gas)
            try:
                st = fn.stat()
                stats.append(f"{st.st_size}:{st.st_mtime_ns}")
            except OSError:
                stats.append("absent")
    h = hashlib.sha256(
        (ctl.table_hash + "|" + "|".join(stats)).encode()).hexdigest()[:16]
    return Path(directory) / f"jurassic_torch_tables_{h}.npz"


def load_tables_cached(ctl: Ctl, directory: str | Path = ".",
                       verbose: bool = True) -> EgaTables:
    """READ_BINARY/WRITE_BINARY semantics (jurassic.c:312-320,669-671):
    read_binary < 0 tries the cache and falls back to the ASCII parse;
    > 0 requires it; write_binary dumps after a successful parse."""
    cf = cache_filename(ctl, directory)
    if ctl.read_binary and cf.exists():
        if verbose:
            print(f"matching binary tables file found: {cf}")
        with np.load(cf) as f:
            return EgaTables(**{k: f[k] for k in EgaTables._fields})
    if ctl.read_binary > 0:
        raise FileNotFoundError(
            f"READ_BINARY > 0 but no cache file {cf}")
    tbl = load_tables(ctl, directory, verbose)
    if ctl.write_binary:
        np.savez(cf, **tbl._asdict())
        if verbose:
            print(f"wrote binary tables cache: {cf}")
    return tbl


# ---------------------------------------------------------------------------
# Fast-mode resampling

LOG2_RATIO_U = 1.0 / 6.0  # u_k = u0 * 2^(k/6): the reference's documented
                          # geometric u-grid (jurassic.c:518-530)


def build_fast_tables(tbl: EgaTables, k_grid: Optional[int] = None) -> FastTables:
    """Resample eps onto exact log-uniform u grids u_k = u0 * 2^(k/6).

    For each (g, p-level, t-level, d) with a usable table (>= 2 entries):
    eps_fast[k] = interp(log2 u_k; log2 u_orig, eps_orig), monotonized so
    the binary-search inversion is well defined.  When the original grid
    is itself 2^(1/6)-geometric (as the reference's FAST_INVERSE_OF_U
    validation asserts for real tables, jurassic.c:518-530), the resample
    reproduces the original eps values exactly.
    """
    G, P, T, U, D = tbl.u.shape
    K = k_grid or U

    np_ = tbl.np_.copy()
    nt = tbl.nt.copy()
    nu = np.zeros((G, P, T, D), np.int32)
    log2_u0 = np.zeros((G, P, T, D))
    eps_f = np.zeros((G, P, T, K, D), np.float32)
    valid = np.zeros((G, P, T, D), bool)

    for ig in range(G):
        for idx in range(D):
            for ip in range(tbl.np_[ig, idx]):
                for it in range(tbl.nt[ig, ip, idx]):
                    n = tbl.nu[ig, ip, it, idx]
                    if n < 2:
                        continue
                    uu = tbl.u[ig, ip, it, :n, idx].astype(np.float64)
                    ee = tbl.eps[ig, ip, it, :n, idx].astype(np.float64)
                    if uu[0] <= 0 or np.any(np.diff(uu) <= 0):
                        continue
                    l2u = np.log2(uu)
                    l2u0 = l2u[0]
                    # number of log-uniform points covering the range
                    nk = min(K, int(np.floor((l2u[-1] - l2u0) / LOG2_RATIO_U
                                             + 1e-6)) + 1)
                    kk = l2u0 + np.arange(nk) * LOG2_RATIO_U
                    eps_k = np.interp(kk, l2u, ee)
                    # monotone non-decreasing guard for invertibility
                    eps_k = np.maximum.accumulate(eps_k)
                    eps_f[ig, ip, it, :nk, idx] = eps_k
                    eps_f[ig, ip, it, nk:, idx] = eps_k[-1]
                    log2_u0[ig, ip, it, idx] = l2u0
                    nu[ig, ip, it, idx] = nk
                    valid[ig, ip, it, idx] = True
    return FastTables(np_=np_, nt=nt, p=tbl.p, t=tbl.t, nu=nu,
                      log2_u0=log2_u0, eps=eps_f, valid=valid,
                      sr=tbl.sr, st=tbl.st)
