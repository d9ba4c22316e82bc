"""Exact log-uniform EGA tables packed for the fused pass ("table mode"),
port of ``build_pallas_tables`` (``jurassic_tpu/ops/pallas/ega_fused.py:
148-247``).

Row layout of ``TableTables.eps_aug`` [G, P*T, K + N_AUG, D], channel
minor:

  rows 0 .. K-1   the eps curve on the log-uniform u grid, padded with
                  ``BIG`` beyond the cell's count
  row  K          log2(u0)
  row  K + 1      temperature axis value of the cell
  row  K + 2      pressure axis value of the cell
  row  K + 3      validity (0 / 1)
  row  K + 4      nk2 = max(count - 2, 0)

Only the TPU layout is dropped: the 128-lane channel padding, the
round-up of the row axis to a multiple of 8 and the channel shards.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..tables import FastTables
from .turbo_fit import pad_small_axes, uniform_axes

BIG = 1.0e30        # eps-row padding sentinel
N_AUG = 5           # rows appended to the K eps rows


class TableTables(NamedTuple):
    """Table-mode tables of the fused EGA pass.

    The array fields are NumPy arrays after the build and torch tensors
    after :meth:`to`."""

    eps_aug: torch.Tensor    # [G, P*T, K + N_AUG, D] f32 (module doc)
    sr: torch.Tensor         # [S, D] f32 source radiance
    chan_mask: torch.Tensor  # [G, D] f32 (np_ >= 2 per channel)
    p_ax: torch.Tensor       # [G, P] f64 channel-uniform pressure axis
    t_ax: torch.Tensor       # [G, P, T] f64 temperature axes
    np_u: torch.Tensor       # [G] int32
    nt_u: torch.Tensor       # [G, P] int32
    k_rows: int              # K
    monotone: bool = True    # every eps row is non-decreasing within its
    #                          count: the CUDA kernel may binary-search

    def to(self, device) -> "TableTables":
        def ten(a):
            if isinstance(a, torch.Tensor):
                return a.to(device)
            return torch.from_numpy(np.array(a)).to(device)
        return self._replace(**{f: ten(getattr(self, f)) for f in
                                ("eps_aug", "sr", "chan_mask", "p_ax",
                                 "t_ax", "np_u", "nt_u")})


def rows_monotone(eps_aug: np.ndarray, k_rows: int) -> bool:
    """Whether every eps row is non-decreasing along K, the ``BIG``
    padding included.  Then the last row <= target, its successor and the
    count/max/min form of the TPU kernel name the same two values."""
    rows = eps_aug[:, :, :k_rows, :]
    return bool((rows[:, :, 1:, :] >= rows[:, :, :-1, :]).all())


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
        eps_aug=eps_aug, sr=np.asarray(ft.sr, np.float32),
        chan_mask=(ft.np_ >= 2).astype(np.float32),
        p_ax=p_ax, t_ax=t_ax, np_u=np_u, nt_u=nt_u, k_rows=K,
        monotone=rows_monotone(eps_aug, K))
    return tt.to(device)


def table_tables_from_jax(eps_aug, sr, chan_mask, p_ax, t_ax, np_u, nt_u,
                          *, k_rows: int, d_true: int, n_chan: int = 1,
                          device="cpu") -> TableTables:
    """The port's container from the fields of a JAX table-mode
    ``PallasTables`` given as NumPy arrays: strips the 128-lane channel
    padding and the 8-row padding of the row axis."""
    if n_chan != 1:
        raise NotImplementedError("channel-sharded tables (n_chan > 1) are "
                                  "a multi-GPU item (ROADMAP.md)")
    K, D = int(k_rows), int(d_true)
    aug = np.asarray(eps_aug, np.float32)
    if aug.ndim != 4 or aug.shape[2] < K + N_AUG or aug.shape[3] < D:
        raise ValueError(f"eps_aug shape {aug.shape} does not hold "
                         f"{K + N_AUG} rows x {D} channels")
    aug = np.ascontiguousarray(aug[:, :, :K + N_AUG, :D])
    tt = TableTables(
        eps_aug=aug,
        sr=np.ascontiguousarray(np.asarray(sr, np.float32)[:, :D]),
        chan_mask=np.ascontiguousarray(
            np.asarray(chan_mask, np.float32)[:, :D]),
        p_ax=np.asarray(p_ax, np.float64), t_ax=np.asarray(t_ax, np.float64),
        np_u=np.asarray(np_u, np.int32), nt_u=np.asarray(nt_u, np.int32),
        k_rows=K, monotone=rows_monotone(aug, K))
    return tt.to(device)
