"""The port's flagship workload is the one ``bench.py`` times: the same
control parameters, tables, atmosphere and limb scan, bit for bit, field
by field across the two packages' class families."""
import numpy as np
import pytest

import bench
import jurassic_torch.config as tcfg
import jurassic_torch.io_tab as tio
import jurassic_torch.tables as ttab
from jurassic_torch.workloads import flagship

from test_torch_host_copies import fields as _fields


@pytest.fixture(scope="module")
def both():
    return flagship(), bench.build_workload()


@pytest.mark.parametrize("part", ["ctl", "fast_tables", "atm", "obs"])
def test_flagship_is_bench_workload(both, part):
    i = ("ctl", "fast_tables", "atm", "obs").index(part)
    cls = (tcfg.Ctl, ttab.FastTables, tio.Atm, tio.Obs)[i]
    assert type(both[0][i]) is cls and type(both[1][i]) is not cls
    got, ref = _fields(both[0][i]), _fields(both[1][i])
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            assert got[k].dtype == v.dtype, k
        else:
            assert got[k] == v, k
