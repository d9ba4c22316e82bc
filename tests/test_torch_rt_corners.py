"""Host-side statements of the RT kernels' exact corner searches and of
the exact tables' device layout, on the CPU.

* ``ops.ega.ega_tables_to_device``: the u and eps rows channel-innermost
  ([G, P, T, U, D], as ``EgaTables`` holds them), an exact permutation
  of the layout the kernels read before ([G, P, T, D, U]).
* ``ops.ega_jvp.exact_row_index`` on rows read through that layout (a
  channel's row at a stride of D): ``ops.ega._count_index``'s index on
  random rows and on rows of the flagship's tables.
* ``ops.ega_jvp.exact_corner_indices``, the plain statement of an exact
  corner's two searches from windows of its rows
  (``csrc/ega_rt_common.cuh``, ``exact_load`` / ``exact_finish``),
  against ``ops.ega._count_index`` and ``ops.ega._lip`` on random rows
  (non-decreasing with ties, shuffled, ragged counts) and on rows of the
  flagship's tables, with hints at, next to and far from the answer.
"""
import numpy as np
import pytest
import torch

from jurassic_torch.models.synthetic import fast_to_ega_tables
from jurassic_torch.ops import ega as tega
from jurassic_torch.ops.ega_jvp import exact_corner_indices, exact_row_index
from jurassic_torch.tables import LOG2_RATIO_U
from jurassic_torch.workloads import flagship, small_limb
from test_torch_host_copies import one_thread  # noqa: F401 (autouse)


def test_device_rows_channel_innermost():
    """The device u and eps are the host tables' values in their own
    [G, P, T, U, D] order; transposed they are the old [G, P, T, D, U]
    rows, so a channel's row is the same values either way."""
    tbl = fast_to_ega_tables(small_limb(ng=3, nd=7, nr=1)[1])
    dt = tega.ega_tables_to_device(tbl, "cpu")
    for name in ("u", "eps"):
        host, dev = getattr(tbl, name), getattr(dt, name)
        assert dev.dtype == torch.float32 and dev.is_contiguous()
        assert tuple(dev.shape) == host.shape
        np.testing.assert_array_equal(dev.numpy(), host)
        old = np.ascontiguousarray(np.swapaxes(host, 3, 4))
        np.testing.assert_array_equal(
            dev.transpose(3, 4).contiguous().numpy(), old)
        g, p, t, d = 2, 5, 3, 6
        np.testing.assert_array_equal(dev[g, p, t, :, d].numpy(),
                                      old[g, p, t, d])
    np.testing.assert_array_equal(dt.nu.numpy(), tbl.nu)


def _strided_rows(rows: np.ndarray, D: int, d: int) -> np.ndarray:
    """The rows [N, U] laid out channel-innermost ([N, U, D], channel d
    holding them, the others noise) and read back at channel d: a view at
    a stride of D entries, as the kernels read a row."""
    rng = np.random.default_rng(D)
    N, U = rows.shape
    lay = rng.uniform(-1e3, 1e3, (N, U, D)).astype(rows.dtype)
    lay[:, :, d] = rows
    view = lay[:, :, d]
    assert view.strides[1] == D * lay.itemsize
    return view


def _row_cases(rows, ns, rng, n_targets):
    """exact_row_index against _count_index on each row, at targets in
    and beyond its range, from hints at, next to and far from it."""
    for row, n in zip(rows, ns):
        n = int(n)
        mono = bool(tega._row_non_decreasing(row[:, None],
                                             np.array([n]))[0])
        m = max(n, 1)
        lo, hi = sorted((float(row[0]), float(row[m - 1])))
        for x in [*rng.uniform(lo - 1, hi + 1, n_targets),
                  float(row[rng.integers(m)])]:
            want = int(tega._count_index(
                torch.from_numpy(np.ascontiguousarray(row))[None].double(),
                torch.tensor([n]), torch.tensor([x]))[0])
            for hint in (want, want + 1, want - 1,
                         int(rng.integers(-2, row.shape[0] + 2))):
                got, _ = exact_row_index(row, n, float(x), mono, hint)
                assert got == want, (n, x, hint, got, want)


def test_exact_row_index_channel_innermost_random_rows():
    """Random rows of U = 37 (sorted with ties, a third shuffled, ragged
    counts 0 to U) read at a stride of D = 9."""
    rng = np.random.default_rng(5)
    U, N = 37, 120
    rows = np.sort(rng.integers(0, 20, (N, U)).astype(np.float32), axis=1)
    rows[::3] = rng.permutation(rows[::3].T).T
    ns = rng.integers(0, U + 1, N)
    _row_cases(_strided_rows(rows, 9, 4), ns, rng, 6)


def test_exact_row_index_channel_innermost_flagship_rows():
    """u and eps rows of the flagship's exact tables ([G, P, T, U, D],
    U = 224) read in place at channels across the band."""
    ft = flagship()[1]
    rng = np.random.default_rng(17)
    G, P, T, U, D = ft.eps.shape
    for _ in range(12):
        g, p, t, d = (int(rng.integers(s)) for s in (G, P, T, D))
        n = np.array([int(ft.nu[g, p, t, d])])
        e = np.asarray(ft.eps[g, p, t, :, d])
        u = np.exp2(ft.log2_u0[g, p, t, d]
                    + np.arange(U) * LOG2_RATIO_U).astype(np.float32)
        for row in (e, u):
            _row_cases(_strided_rows(row[None], D, d), n, rng, 4)


def _want(e_row, u_row, n, target, u_seg):
    """(i, j) by ``_count_index`` and ``_lip`` (ops.ega._ega_exact)."""
    e, u = torch.from_numpy(e_row)[None], torch.from_numpy(u_row)[None]
    cnt = torch.tensor([n])
    x = torch.tensor([target], dtype=torch.float64)
    i = tega._count_index(e, cnt, x)
    last = lambda r, k: tega._last(r, k)
    u_new = tega._lip(last(e, i), last(u, i), last(e, i + 1),
                      last(u, i + 1), x) + u_seg
    j = tega._count_index(u, cnt, u_new)
    return int(i[0]), int(j[0])


def _hold(e_rows, u_rows, ns, rng, n_cases):
    """exact_corner_indices against _want on the rows; how often each
    path answered."""
    paths = {}
    U = e_rows.shape[1]
    for _ in range(n_cases):
        k = rng.integers(len(e_rows))
        e_row, u_row, n = e_rows[k], u_rows[k], int(ns[k])
        mono = int(tega._row_non_decreasing(e_row[:, None],
                                            np.array([n]))[0]) \
            + 2 * int(tega._row_non_decreasing(u_row[:, None],
                                               np.array([n]))[0])
        m = max(n, 1)
        lo, hi = sorted((float(e_row[0]), float(e_row[m - 1])))
        target = float(rng.uniform(lo, hi)) if rng.integers(4) \
            else float(e_row[rng.integers(m)])
        u_seg = float(rng.choice([0.0, rng.uniform(0, 1e-3) * abs(u_row[0]),
                                  rng.uniform(0, 1) * abs(u_row[m - 1])]))
        want = _want(e_row, u_row, n, target, u_seg)
        for hint in (want[1], want[0], want[0] - 1, want[0] + 1,
                     int(rng.integers(-2, U + 2))):
            got = exact_corner_indices(e_row, u_row, n, mono, hint, target,
                                       u_seg)
            assert got[:2] == want, (k, n, target, u_seg, hint, got)
            paths[got[2]] = paths.get(got[2], 0) + 1
    return paths


@pytest.mark.parametrize("seed,U", [(11, 29), (23, 8), (31, 64)])
def test_exact_corner_indices_random_rows(seed, U):
    """Rows of U entries: non-decreasing with ties over counts 0 to U, a
    third of the eps rows shuffled, padding random."""
    rng = np.random.default_rng(seed)
    N = 300
    e = np.sort(rng.integers(0, 15, (N, U)).astype(np.float64), axis=1)
    u = np.sort(rng.uniform(0, 100, (N, U)), axis=1)
    ns = rng.integers(0, U + 1, N)
    pad = np.arange(U)[None, :] >= ns[:, None]
    e = np.where(pad, rng.uniform(-50, 50, e.shape), e)
    e[::3] = rng.permutation(e[::3].T).T
    paths = _hold(e, u, ns, rng, 1500)
    assert {"window", "eps row", "u row", "rows", "corner"} <= set(paths)


def test_exact_corner_indices_flagship_rows():
    """Rows of the flagship's tables (eps, and u = u0 2^(k / 6) as
    ``models.synthetic.fast_to_ega_tables`` makes it; U = 224)."""
    ft = flagship()[1]
    rng = np.random.default_rng(13)
    G, P, T, U, D = ft.eps.shape
    cells = [tuple(rng.integers(s) for s in (G, P, T, D)) for _ in range(80)]
    e = np.stack([np.asarray(ft.eps[g, p, t, :, d], np.float64)
                  for g, p, t, d in cells])
    u = np.stack([np.exp2(ft.log2_u0[g, p, t, d]
                          + np.arange(U) * LOG2_RATIO_U).astype(np.float32)
                  .astype(np.float64) for g, p, t, d in cells])
    ns = np.array([int(ft.nu[c]) for c in cells])
    paths = _hold(e, u, ns, rng, 600)
    assert paths.get("window", 0) > paths.get("eps row", 0) > 0
