"""The table layout the CUDA kernels read, and the row search of the
table-mode kernel, stated in Python.

``pack_rows`` stores four consecutive rows of one channel in one
``float4`` ([G, P*T, ceil(Q/4), D, 4]); ``unpack_rows`` must give back the
logical table bit for bit, without the pad rows, for channel counts that
are not a multiple of the warp and for row counts that are not a multiple
of four.  ``hinted_count`` is the search the kernel runs on that layout
(hinted group, gallop, bisect); on a non-decreasing row it must equal the
plain count for every hint.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jurassic_torch.ops.table_pack import BIG, hinted_count
from jurassic_torch.ops.turbo_fit import pack_rows, unpack_rows


def _table(q, d, seed=0):
    rng = np.random.default_rng(seed)
    # no zero anywhere, so that a pad row (zeros) cannot pass for data
    return rng.uniform(0.5, 1.5, (3, 7, q, d)).astype(np.float32)


@pytest.mark.parametrize("d", [9, 100, 130])
@pytest.mark.parametrize("q", [39, 229])
def test_pack_rows_roundtrip_numpy(q, d):
    rows = _table(q, d)
    packed = pack_rows(rows)
    q4 = -(-q // 4)
    assert packed.shape == (3, 7, q4, d, 4) and packed.dtype == np.float32
    assert packed.flags["C_CONTIGUOUS"]
    # element [g, c, a, d, b] is row 4 a + b of channel d
    for k in (0, 1, 5, q - 1):
        assert np.array_equal(packed[:, :, k // 4, :, k % 4], rows[:, :, k])
    back = unpack_rows(packed, q)
    assert back.shape == rows.shape
    assert back.tobytes() == np.ascontiguousarray(rows).tobytes()
    # the pad rows are zero and never surface
    full = unpack_rows(packed, 4 * q4)
    assert not full[:, :, q:].any()
    assert (back != 0).all()


@pytest.mark.parametrize("d", [9, 100, 130])
@pytest.mark.parametrize("q", [39, 229])
def test_pack_rows_roundtrip_torch(q, d):
    rows = _table(q, d, seed=1)
    packed_t = pack_rows(torch.from_numpy(rows))
    assert packed_t.is_contiguous()
    assert np.array_equal(packed_t.numpy(), pack_rows(rows))
    assert torch.equal(unpack_rows(packed_t, q), torch.from_numpy(rows))
    # gathered cells ([..., Q4, D, 4] with more leading axes) unpack alike
    sel = torch.tensor([[0, 3], [6, 6]])
    blk = unpack_rows(packed_t.reshape(21, -(-q // 4), d, 4)[sel], q)
    assert torch.equal(blk, torch.from_numpy(rows).reshape(21, q, d)[sel])


def test_unpack_rows_refuses_wrong_shapes():
    packed = pack_rows(_table(39, 9))
    with pytest.raises(ValueError):
        unpack_rows(packed, 41)
    with pytest.raises(ValueError):
        unpack_rows(packed[..., :3], 39)


def _cold(row, x):
    return int(np.sum(row <= x))


def _monotone_row(k, n_live, seed):
    """A table row: n_live non-decreasing values in (0, 1) with ties,
    then the BIG padding."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(np.linspace(0.01, 0.99, 40), n_live))
    return np.concatenate([live, np.full(k - n_live, BIG)]).astype(
        np.float32)


@pytest.mark.parametrize("k,n_live", [(224, 224), (224, 150), (48, 48),
                                      (48, 7), (13, 13), (5, 2), (1, 1)])
def test_hinted_count_equals_cold_count_for_every_hint(k, n_live):
    row = _monotone_row(k, n_live, seed=k + n_live)
    live = row[:n_live]
    targets = np.concatenate([
        [-1.0, 0.0, live[0] - 1e-6],                   # below the row
        live, live + np.float32(1e-6), live - np.float32(1e-6),  # on ties
        0.5 * (live[:-1] + live[1:]),                  # inside
        [live[-1] + 1e-3, 1.0, 2.0, 2 * BIG]]).astype(np.float32)
    ng = -(-k // 4)
    for x in targets:
        want = _cold(row, x)
        for hint in range(ng):
            got, group = hinted_count(row, x, hint)
            assert got == want, (x, hint)
            # the group found holds the answer and is the next hint
            assert 0 <= group < ng and 4 * group <= want <= 4 * group + 4
            assert hinted_count(row, x, group) == (want, group)


@settings(max_examples=200, deadline=None, database=None)
@given(vals=st.lists(st.floats(0.0, 1.0, width=32), min_size=1,
                     max_size=70),
       x=st.floats(-0.5, 1.5, width=32), hint=st.integers(0, 1000),
       pad=st.integers(0, 9))
def test_hinted_count_property(vals, x, hint, pad):
    row = np.concatenate([np.sort(np.asarray(vals, np.float32)),
                          np.full(pad, BIG, np.float32)])
    ng = -(-len(row) // 4)
    got, group = hinted_count(row, np.float32(x), hint % ng)
    assert got == _cold(row, np.float32(x))
    assert 0 <= group < ng


def test_hinted_count_refuses_hint_outside_the_row():
    with pytest.raises(ValueError):
        hinted_count(np.arange(8, dtype=np.float32), 3.0, 2)
