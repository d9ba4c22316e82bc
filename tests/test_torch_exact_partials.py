"""The exact-table pieces of the RT kernels' plain statements, float64 on
the CPU.

* ``ops.ega.ega_eps_exact_partials`` against ``torch.func.jvp`` of
  ``ega_eps_exact`` in each input direction (tau_path, t, p and each
  gas's u_seg), at 1e-12 of each output's largest |tangent|, its factor
  bit for bit ``ega_eps_exact``'s: on random ragged tables (missing
  tables, rows of 0 and 1 points, garbage beyond each count; the tables of
  ``tests/test_torch_ega_eager.py``) with one eps row and one u row that
  decrease within their count, and on the small limb scan's exact tables.
* ``ops.ega.rows_monotone_exact``: the per-row decision the kernels
  search by (halving with a hint, or a count).
* ``ops.ega_jvp.exact_row_index``, the plain statement of the kernels'
  row search, against ``ops.ega._count_index`` on random rows
  (non-decreasing with ties, of every count up to U, and not; targets on
  the rows' values, beyond both ends, NaN and between; hints at, next to
  and far from the answer) and on rows of the flagship's exact tables.
"""
import numpy as np
import pytest
import torch

from jurassic_torch.models.synthetic import fast_to_ega_tables
from jurassic_torch.ops import ega as tega
from jurassic_torch.ops.ega_jvp import exact_row_index
from jurassic_torch.workloads import flagship, small_limb
from test_torch_ega_eager import random_states, random_tables
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)

BAR = 1e-12


def _decreasing(tbl):
    """``tbl`` with the eps row of one cell and the u row of another
    decreasing within their counts."""
    nu, eps, u = np.array(tbl.nu), np.array(tbl.eps), np.array(tbl.u)
    cells = np.argwhere(nu >= 5)
    (g, p, t, d), (g2, p2, t2, d2) = cells[0], cells[-1]
    eps[g, p, t, 1, d], eps[g, p, t, 3, d] = eps[g, p, t, 3, d], \
        eps[g, p, t, 1, d]
    u[g2, p2, t2, 0, d2] = u[g2, p2, t2, 2, d2] * 2.0
    return tbl._replace(eps=eps, u=u), (g, p, t, d), (g2, p2, t2, d2)


@pytest.mark.parametrize("case", ["random0", "random1", "small_limb"])
def test_exact_partials_match_jvp(case, capsys):
    if case == "small_limb":
        tbl = fast_to_ega_tables(small_limb(ng=3, nd=5, nr=1)[1])
    else:
        tbl = random_tables(int(case[-1]))
    tbl, _, _ = _decreasing(tbl)
    dt = tega.ega_tables_to_device(tbl, "cpu")
    assert "count those rows linearly" in capsys.readouterr().out
    G, _, _, _, D = tbl.u.shape
    tp, t, u, p = (torch.from_numpy(x) for x in random_states(7, 61, G, D))
    out = tega.ega_eps_exact_partials(dt, tp, t, u, p)
    assert torch.equal(out[0], tega.ega_eps_exact(dt, tp, t, u, p))
    assert ((out[0] > 0) & (out[0] < 1)).sum() > out[0].numel() // 5
    base = (tp, t, u, p)
    zero = [torch.zeros_like(x) for x in base]

    def jvp(i, d):
        dirs = list(zero)
        dirs[i] = d
        return torch.func.jvp(
            lambda a, b, c, e: tega.ega_eps_exact(dt, a, b, c, e), base,
            tuple(dirs))[1]
    checks = [(out[1], jvp(0, torch.ones_like(tp))),
              (out[2], jvp(1, torch.ones_like(t))),
              (out[3], jvp(3, torch.ones_like(p)))]
    for g in range(G):
        d = torch.zeros_like(u)
        d[:, g] = 1.0
        checks.append((out[4][:, g], jvp(2, d)[:, g]))
    for k, (got, ref) in enumerate(checks):
        scale = float(ref.abs().max())
        assert scale > 0, k
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=BAR * scale, err_msg=f"partial {k}")


def test_rows_monotone_exact_decision():
    """Bit 0 (eps) and bit 1 (u) of each cell: set on ascending rows and
    on rows of 0 or 1 points, cleared where a row decreases within its
    count, holds a NaN, or counts more points than it has."""
    tbl = random_tables(0)
    mono = tega.rows_monotone_exact(tbl)
    assert mono.shape == tbl.nu.shape and (mono == 3).all()
    bad, ce, cu = _decreasing(tbl)
    mono = tega.rows_monotone_exact(bad)
    assert mono[ce] == 2 and mono[cu] == 1
    assert (mono == 3).sum() == mono.size - 2
    eps = np.array(tbl.eps)
    g, p, t, d = np.argwhere(np.asarray(tbl.nu) >= 2)[0]
    eps[g, p, t, 0, d] = np.nan
    nu = np.array(tbl.nu)
    nu[tuple(np.argwhere(nu >= 2)[-1])] = tbl.u.shape[3] + 1
    mono = tega.rows_monotone_exact(tbl._replace(eps=eps, nu=nu))
    assert mono[g, p, t, d] == 2
    assert mono[tuple(np.argwhere(nu > tbl.u.shape[3])[0])] == 0


def _targets(rng, row, n):
    """A target on the row, below or above it, NaN, or between."""
    pick = rng.integers(4)
    if pick == 0:
        return float(row[rng.integers(max(n, 1))])
    if pick == 1:
        return float(row[0]) - 1.0 if rng.integers(2) else \
            float(row[max(n - 1, 0)]) + 1.0
    if pick == 2:
        return float("nan")
    ends = sorted((float(row[0]), float(row[max(n - 1, 0)])))
    return float(rng.uniform(*ends))


def _hold(rows, ns, rng, n_cases):
    """exact_row_index against _count_index on ``rows`` [N, U] with
    counts ``ns``; returns how often each path answered."""
    paths = {}
    U = rows.shape[1]
    for _ in range(n_cases):
        i = rng.integers(len(rows))
        row, n = rows[i], int(ns[i])
        mono = bool(tega._row_non_decreasing(row[:, None],
                                             np.array([n]))[0])
        x = _targets(rng, row, n)
        want = int(tega._count_index(torch.from_numpy(row)[None],
                                     torch.tensor([n]),
                                     torch.tensor([x], dtype=torch.float64)
                                     )[0])
        for hint in (want, want - 1, want + 1, want + 2,
                     int(rng.integers(-2, U + 2))):
            got, path = exact_row_index(row, n, x, mono, hint)
            assert got == want, (i, n, x, hint, path)
            paths[path] = paths.get(path, 0) + 1
    return paths


def test_exact_row_index_random():
    """Random rows of U = 37 values: non-decreasing with ties over counts
    0 to U (padding beyond them random), and shuffled ones."""
    rng = np.random.default_rng(3)
    U = 37
    rows = np.sort(rng.integers(0, 20, (600, U)).astype(np.float64), axis=1)
    ns = rng.integers(0, U + 1, 600)
    pad = np.arange(U)[None, :] >= ns[:, None]
    rows = np.where(pad, rng.uniform(-50, 50, rows.shape), rows)
    rows[::3] = rng.permutation(rows[::3].T).T
    paths = _hold(rows, ns, rng, 3000)
    assert {"hint", "halving", "count", "short"} <= set(paths)


def test_exact_row_index_flagship_rows():
    """Rows of the flagship's exact tables (u and eps, U = 224, every
    row monotone), targets drawn on and between their values."""
    tbl = fast_to_ega_tables(flagship()[1])
    assert (tega.rows_monotone_exact(tbl) == 3).all()
    rng = np.random.default_rng(5)
    G, P, T, U, D = tbl.u.shape
    idx = [tuple(rng.integers(s) for s in (G, P, T)) + (slice(None),
                                                          rng.integers(D))
           for _ in range(150)]
    ns = np.array([int(tbl.nu[g, p, t, d]) for g, p, t, _, d in idx] * 2)
    rows = np.stack([np.asarray(tbl.eps[i], np.float64) for i in idx]
                    + [np.asarray(tbl.u[i], np.float64) for i in idx])
    paths = _hold(rows, ns, rng, 1500)
    assert paths.get("hint", 0) > 0 and paths.get("halving", 0) > 0
