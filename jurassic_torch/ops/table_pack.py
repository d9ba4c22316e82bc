"""Exact log-uniform EGA tables packed for the fused pass ("table mode"),
port of ``build_pallas_tables`` (``jurassic_tpu/ops/pallas/ega_fused.py:
148-247``).

Row layout of the logical table [G, P*T, K + N_AUG, D], channel minor:

  rows 0 .. K-1   the eps curve on the log-uniform u grid, padded with
                  ``BIG`` beyond the cell's count
  row  K          log2(u0)
  row  K + 1      temperature axis value of the cell
  row  K + 2      pressure axis value of the cell
  row  K + 3      validity (0 / 1)
  row  K + 4      nk2 = max(count - 2, 0)

Only the TPU layout is dropped: the 128-lane channel padding, the
round-up of the row axis to a multiple of 8 and the channel shards.

``TableTables.eps_aug`` holds these rows packed for 16-byte loads
(``turbo_fit.pack_rows``): [G, P*T, ceil((K + N_AUG)/4), D, 4], four
consecutive rows of one channel in one ``float4``.  That is the only copy
kept; :meth:`TableTables.rows` unpacks the logical table from it.

:func:`hinted_count` states in NumPy the row search the CUDA kernel runs
on that layout: it starts at the group of four rows the last segment
found, gallops outwards and bisects.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..tables import FastTables
from .turbo_fit import (pack_rows, pad_small_axes, uniform_axes,
                        unpack_rows, unshard_lanes)

BIG = 1.0e30        # eps-row padding sentinel
N_AUG = 5           # rows appended to the K eps rows


class TableTables(NamedTuple):
    """Table-mode tables of the fused EGA pass.

    The array fields are NumPy arrays after the build and torch tensors
    after :meth:`to`."""

    eps_aug: torch.Tensor    # [G, P*T, ceil((K + N_AUG)/4), D, 4] f32
    sr: torch.Tensor         # [S, D] f32 source radiance
    chan_mask: torch.Tensor  # [G, D] f32 (np_ >= 2 per channel)
    p_ax: torch.Tensor       # [G, P] f64 channel-uniform pressure axis
    t_ax: torch.Tensor       # [G, P, T] f64 temperature axes
    np_u: torch.Tensor       # [G] int32
    nt_u: torch.Tensor       # [G, P] int32
    k_rows: int              # K
    monotone: bool = True    # every eps row is non-decreasing within its
    #                          count: the CUDA kernel may search

    def rows(self):
        """The logical table [G, P*T, K + N_AUG, D], unpacked (a copy)."""
        return unpack_rows(self.eps_aug, self.k_rows + N_AUG)

    def to(self, device) -> "TableTables":
        def ten(a):
            if isinstance(a, torch.Tensor):
                return a.to(device)
            return torch.from_numpy(np.array(a)).to(device)
        return self._replace(**{f: ten(getattr(self, f)) for f in
                                ("eps_aug", "sr", "chan_mask", "p_ax",
                                 "t_ax", "np_u", "nt_u")})


def rows_monotone(eps_aug: np.ndarray, k_rows: int) -> bool:
    """Whether every eps row of the logical table is non-decreasing along
    K, the ``BIG`` padding included.  Then the last row <= target, its
    successor and the count/max/min form of the TPU kernel name the same
    two values."""
    rows = eps_aug[:, :, :k_rows, :]
    return bool((rows[:, :, 1:, :] >= rows[:, :, :-1, :]).all())


def hinted_count(row: np.ndarray, x: float, hint: int) -> tuple[int, int]:
    """(#{k : row[k] <= x}, group found) on a non-decreasing ``row`` of K
    values, searched as the CUDA kernel searches the packed layout: in
    groups of four consecutive rows (one ``float4``), starting at group
    ``hint`` (0 <= hint < ceil(K/4)).

    With first(a) = row[4 a], the answer lies in the last group a* whose
    first row is <= x (group 0 if none): count = 4 a* + the rows of that
    group that are <= x.  The search tests the hinted group; if its first
    row is above x it gallops left (steps 1, 2, 4, ...) to a group whose
    first row is not, if all its rows are <= x it gallops right to a group
    whose first row is above x; it stops as soon as a group holds a row
    above x and otherwise bisects the groups between.  On a
    non-decreasing row this is the cold count whatever the hint."""
    K = len(row)
    ng = -(-K // 4)
    if not 0 <= hint < ng:
        raise ValueError(f"hint {hint} outside [0, {ng})")

    def in_group(a):
        return int(np.sum(row[4 * a:4 * a + 4] <= x))

    def bisect(lo, hi):         # first(lo) <= x or lo == 0; first(hi) > x
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if row[4 * mid] <= x:
                lo = mid
            else:
                hi = mid
        return lo

    def full(a):                # every row of group a is <= x
        return in_group(a) == min(4, K - 4 * a)

    a = hint
    if a > 0 and not row[4 * a] <= x:
        hi, step = a, 1
        while True:
            lo = max(hi - step, 0)
            if lo == 0 or row[4 * lo] <= x:
                break
            hi, step = lo, 2 * step
        a = bisect(lo, hi) if full(lo) else lo
    elif full(a) and a + 1 < ng:
        lo, step = a, 1
        while True:
            hi = min(lo + step, ng)
            if hi == ng or not row[4 * hi] <= x:
                break
            lo, step = hi, 2 * step
            if not full(lo):    # the answer is in this group
                hi = lo + 1
                break
        a = bisect(lo, hi)
    return 4 * a + in_group(a), a


def build_table_tables(ft: FastTables, device="cpu") -> TableTables | None:
    """Pack FastTables for the table-mode pass on ``device``; None when
    the (p, T) axes are not channel-uniform per gas (over channels that
    have a table)."""
    ft = pad_small_axes(ft)
    G, P, T, K, D = ft.eps.shape
    ax = uniform_axes(ft)
    if ax is None:
        return None
    p_ax, t_ax, np_u, nt_u = ax

    eps_aug = np.zeros((G, P * T, K + N_AUG, D), np.float32)
    eps = ft.eps.reshape(G, P * T, K, D)
    nu = ft.nu.reshape(G, P * T, D)
    nt3 = np.repeat(ft.nt, T, axis=1)                       # [G, P*T, D]
    valid = ft.valid.reshape(G, P * T, D) & (nu >= 2) & (nt3 >= 2)
    pad = np.arange(K)[None, None, :, None] >= nu[:, :, None, :]
    eps_aug[:, :, :K, :] = np.where(pad, BIG, eps)
    eps_aug[:, :, K, :] = ft.log2_u0.reshape(G, P * T, D)
    eps_aug[:, :, K + 1, :] = ft.t.reshape(G, P * T, D)
    eps_aug[:, :, K + 2, :] = np.repeat(
        ft.p[:, :, None, :], T, axis=2).reshape(G, P * T, D)
    eps_aug[:, :, K + 3, :] = valid.astype(np.float32)
    eps_aug[:, :, K + 4, :] = np.maximum(nu - 2, 0).astype(np.float32)

    tt = TableTables(
        eps_aug=pack_rows(eps_aug), sr=np.asarray(ft.sr, np.float32),
        chan_mask=(ft.np_ >= 2).astype(np.float32),
        p_ax=p_ax, t_ax=t_ax, np_u=np_u, nt_u=nt_u, k_rows=K,
        monotone=rows_monotone(eps_aug, K))
    return tt.to(device)


def table_tables_from_jax(eps_aug, sr, chan_mask, p_ax, t_ax, np_u, nt_u,
                          *, k_rows: int, d_true: int, n_chan: int = 1,
                          shard: int | None = None,
                          device="cpu") -> TableTables:
    """The port's container from the fields of a JAX table-mode
    ``PallasTables`` given as NumPy arrays: strips the 128-lane channel
    padding of each of the ``n_chan`` channel shards (``d_true`` true
    channels each, ``turbo_fit.unshard_lanes``) and the 8-row padding of
    the row axis.  All ``n_chan * d_true`` channels, or the channel range
    of shard ``shard``."""
    K = int(k_rows)
    aug = np.asarray(eps_aug, np.float32)
    if aug.ndim != 4 or aug.shape[2] < K + N_AUG:
        raise ValueError(f"eps_aug shape {aug.shape} does not hold "
                         f"{K + N_AUG} rows")
    lanes = lambda a: unshard_lanes(a, n_chan, int(d_true), shard)
    aug = lanes(aug[:, :, :K + N_AUG, :])
    tt = TableTables(
        eps_aug=pack_rows(aug), sr=lanes(np.asarray(sr, np.float32)),
        chan_mask=lanes(np.asarray(chan_mask, np.float32)),
        p_ax=np.asarray(p_ax, np.float64), t_ax=np.asarray(t_ax, np.float64),
        np_u=np.asarray(np_u, np.int32), nt_u=np.asarray(nt_u, np.int32),
        k_rows=K, monotone=rows_monotone(aug, K))
    return tt.to(device)
