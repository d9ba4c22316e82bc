"""The port's flagship workload is the one ``bench.py`` times: the same
control parameters, tables, atmosphere and limb scan, bit for bit."""
import dataclasses

import numpy as np
import pytest

import bench
from jurassic_torch.workloads import flagship


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return obj._asdict()


@pytest.fixture(scope="module")
def both():
    return flagship(), bench.build_workload()


@pytest.mark.parametrize("part", ["ctl", "fast_tables", "atm", "obs"])
def test_flagship_is_bench_workload(both, part):
    i = ("ctl", "fast_tables", "atm", "obs").index(part)
    got, ref = _fields(both[0][i]), _fields(both[1][i])
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            assert got[k].dtype == v.dtype, k
        else:
            assert got[k] == v, k
