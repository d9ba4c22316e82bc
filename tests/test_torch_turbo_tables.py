"""The port's turbo table build against the JAX package's, byte for byte.

``jurassic_torch.ops.turbo_fit.build_turbo_tables`` must pack exactly
the JAX package's coefficient and aux planes once the TPU layout (the
128-lane channel padding and the 8-row padding of the coefficient axis)
is stripped, and report the same bad-row count and TurboStats;
``turbo_tables_from_jax`` must carry JAX-built tables across unchanged.
"""
from pathlib import Path

import numpy as np
import pytest

from jurassic_tpu.config import read_ctl
from jurassic_tpu.models.synthetic import (synthetic_ctl,
                                           synthetic_fast_tables)
from jurassic_tpu.ops.pallas import build_turbo_tables as jax_build
from jurassic_tpu.tables import build_fast_tables, load_tables
from jurassic_torch.ops.turbo_fit import (N_TURBO_AUX, build_turbo_tables,
                                          turbo_tables_from_jax)

from test_torch_cli import _roughen
from test_torch_host_copies import port_fast_tables

GOLD = Path(__file__).parent / "goldens"
FIELDS = ("coef", "sr", "chan_mask", "p_ax", "t_ax", "np_u", "nt_u")


def _fast_tables(case):
    if case in ("synthetic", "rough"):
        ctl = synthetic_ctl(ng=4, nd=9)
        ft = synthetic_fast_tables(ctl, n_p=8, n_t=5, n_k=48)
        if case == "rough":
            # three jagged cells fail the per-row gate (the hybrid case
            # of test_pallas_kernel.py:369-401)
            ft = _roughen(ft, ((3, 2), (4, 2), (4, 3)))
        return ft
    d = GOLD / case
    ctl = read_ctl(["formod", str(next(d.glob("*.ctl"))), "o", "a", "r"],
                   verbose=False)
    ctl.tblbase = str(d / Path(ctl.tblbase).name)
    return build_fast_tables(load_tables(ctl, d, verbose=False))


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("case", ["synthetic", "rough", "ega", "limb"])
def test_turbo_tables_match_jax_bytewise(case):
    ft = _fast_tables(case)
    pt, st_j = jax_build(ft)
    tt, st_t = build_turbo_tables(port_fast_tables(ft))
    D = pt.d_true
    Q = pt.deg_f + 1 + pt.deg_i + 1 + N_TURBO_AUX
    eps_aug = np.asarray(pt.eps_aug)
    assert tuple(tt.coef.shape) == eps_aug.shape[:2] + (Q, D)
    # coefficient + aux planes (incl. ROW_VALID), lane padding stripped
    assert _same_bytes(tt.coef.numpy(), eps_aug[:, :, :Q, :D])
    # what was stripped is padding
    assert not eps_aug[:, :, Q:, :].any() and not eps_aug[..., D:].any()
    assert _same_bytes(tt.sr.numpy(), np.asarray(pt.sr)[:, :D])
    assert _same_bytes(tt.chan_mask.numpy(),
                       np.asarray(pt.chan_mask)[:, :D])
    for f in ("p_ax", "t_ax", "np_u", "nt_u"):
        assert _same_bytes(getattr(tt, f).numpy(), getattr(pt, f)), f
    assert (tt.deg_f, tt.deg_i, tt.n_bad) == (pt.deg_f, pt.deg_i, pt.n_bad)
    assert st_t == st_j
    if case == "rough":
        assert tt.n_bad == 3
    if case == "limb":
        # stub tables: no row fitted, no channel has a table
        assert st_t.rows == 0 and not tt.chan_mask.numpy().any()

    # tables fitted by JAX carried across: the same container
    tj = turbo_tables_from_jax(
        *(np.asarray(getattr(pt, f)) for f in
          ("eps_aug", "sr", "chan_mask", "p_ax", "t_ax", "np_u", "nt_u")),
        d_true=pt.d_true, deg_f=pt.deg_f, deg_i=pt.deg_i, n_bad=pt.n_bad)
    for f in FIELDS:
        assert _same_bytes(getattr(tj, f).numpy(),
                           getattr(tt, f).numpy()), f
    assert (tj.deg_f, tj.deg_i, tj.n_bad) == (tt.deg_f, tt.deg_i, tt.n_bad)


def test_turbo_cache_roundtrip(tmp_path):
    """The content-keyed fit cache returns the tables it stored."""
    from jurassic_torch.ops.turbo_fit import build_turbo_tables_cached

    ft = port_fast_tables(_fast_tables("synthetic"))
    tt0, st0 = build_turbo_tables(ft)
    tt1, st1 = build_turbo_tables_cached(ft, tmp_path)
    assert len(list(tmp_path.glob("turbo_*.npz"))) == 1
    tt2, st2 = build_turbo_tables_cached(ft, tmp_path)
    assert st0 == st1 == st2
    for f in FIELDS:
        assert _same_bytes(getattr(tt2, f).numpy(), getattr(tt0, f).numpy())
    assert (tt2.deg_f, tt2.deg_i, tt2.n_bad) == (8, 8, 0)
