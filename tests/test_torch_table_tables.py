"""The port's table-mode table build against the JAX package's, byte for
byte.

``jurassic_torch.ops.table_pack.build_table_tables`` must pack exactly
the rows of ``build_pallas_tables`` once the TPU layout (the 128-lane
channel padding and the round-up of the row axis to a multiple of 8) is
stripped; ``table_tables_from_jax`` must carry JAX-built tables across
unchanged; ragged axes give None on both sides.  Everything is NumPy, so
the comparison is exact.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from jurassic_tpu.ops.pallas import build_pallas_tables
from jurassic_tpu.tables import build_fast_tables, load_tables
from jurassic_torch.ops.table_pack import (BIG, N_AUG, build_table_tables,
                                           rows_monotone,
                                           table_tables_from_jax)

from test_torch_cli import _roughen
from test_torch_host_copies import (golden_case, port_fast_tables,
                                    small_limb_pair)
import jurassic_tpu.config as jcfg
import jurassic_tpu.io_tab as jio

REPO = Path(__file__).resolve().parents[1]
GOLD = REPO / "tests" / "goldens"
FIELDS = ("eps_aug", "sr", "chan_mask", "p_ax", "t_ax", "np_u", "nt_u")


def _jax_fast_tables(case, tmp_path):
    """FastTables of the JAX package for a case."""
    if case in ("synthetic", "rough"):
        (_c, ft, _a, _o), _ = small_limb_pair(ng=4, nd=9, nr=2)
        return _roughen(ft, ((3, 2), (4, 2), (4, 3))) \
            if case == "rough" else ft
    ctl, _obs, _atm = golden_case(case, jcfg, jio)
    d = GOLD / case
    if case == "gas30":
        # its tables regenerate deterministically (test_gas30_golden.py)
        gases = [g for g in ctl.emitter[:ctl.ng] if g not in ("N2", "O2")]
        subprocess.run(
            [sys.executable, str(REPO / "tools" / "make_synthetic_tables.py"),
             str(tmp_path), "--tblbase", "synth", "--gases", *gases,
             "--channels", *[f"{x:.4f}" for x in ctl.nu]],
            check=True, stdout=subprocess.DEVNULL)
        for f in d.glob("*.filt"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
        ctl.tblbase, d = str(tmp_path / "synth"), tmp_path
    return build_fast_tables(load_tables(ctl, d, verbose=False))


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("case", ["synthetic", "rough", "ega", "limb",
                                  "gas30"])
def test_table_tables_match_jax_bytewise(case, tmp_path):
    ft_j = _jax_fast_tables(case, tmp_path)
    pt = build_pallas_tables(ft_j)
    tt = build_table_tables(port_fast_tables(ft_j))
    assert pt.mode == "table"
    K, D = pt.k_rows, pt.d_true
    aug = np.asarray(pt.eps_aug)
    assert tt.k_rows == K
    assert tuple(tt.eps_aug.shape) == aug.shape[:2] + (K + N_AUG, D)
    assert _same_bytes(tt.eps_aug.numpy(), aug[:, :, :K + N_AUG, :D])
    # what was stripped is padding
    assert not aug[:, :, K + N_AUG:, :].any() and not aug[..., D:].any()
    assert _same_bytes(tt.sr.numpy(), np.asarray(pt.sr)[:, :D])
    assert _same_bytes(tt.chan_mask.numpy(), np.asarray(pt.chan_mask)[:, :D])
    for f in ("p_ax", "t_ax", "np_u", "nt_u"):
        assert _same_bytes(getattr(tt, f).numpy(), getattr(pt, f)), f
    if case == "gas30":
        assert tt.eps_aug.shape[0] == 30
    # monotone rows: build_fast_tables monotonises, the staircase is
    # monotone by construction
    assert tt.monotone

    tj = table_tables_from_jax(
        *(np.asarray(getattr(pt, f)) for f in FIELDS),
        k_rows=pt.k_rows, d_true=pt.d_true)
    for f in FIELDS:
        assert _same_bytes(getattr(tj, f).numpy(), getattr(tt, f).numpy()), f
    assert (tj.k_rows, tj.monotone) == (tt.k_rows, tt.monotone)


def test_ragged_axes_give_none():
    (_c, ft, _a, _o), _ = small_limb_pair(ng=2, nd=4, nr=2, n_p=6, n_t=4,
                                          n_k=32)
    p = np.array(ft.p)
    p[0, :, 1] *= 1.5
    ft = ft._replace(p=p)
    assert build_pallas_tables(ft) is None
    assert build_table_tables(port_fast_tables(ft)) is None


def test_non_monotone_rows_are_flagged():
    (_c, ft, _a, _o), _ = small_limb_pair(ng=2, nd=4, nr=2)
    eps = np.array(ft.eps)
    eps[1, 2, 3, 5, 0] = eps[1, 2, 3, 7, 0] + 0.01      # a bump in one row
    tt = build_table_tables(port_fast_tables(ft._replace(eps=eps)))
    assert not tt.monotone
    aug = tt.eps_aug.numpy()
    assert not rows_monotone(aug, tt.k_rows)
    assert (aug[:, :, :tt.k_rows] <= BIG).all()


def test_from_jax_refuses_channel_shards():
    (_c, ft, _a, _o), _ = small_limb_pair(ng=2, nd=4, nr=2)
    pt = build_pallas_tables(ft)
    with pytest.raises(NotImplementedError, match="n_chan"):
        table_tables_from_jax(
            *(np.asarray(getattr(pt, f)) for f in FIELDS),
            k_rows=pt.k_rows, d_true=pt.d_true, n_chan=2)
