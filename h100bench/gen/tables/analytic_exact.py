"""The synthetic analytic tables in upstream's exact ``tbl_t`` form: a u
row beside every eps row.  Every row is full (``tblnu`` points) and all
hold the same eps row, so no count is ragged."""
from h100bench.gen import synthetic


def make(cfg: dict):
    ft = synthetic.fast_tables(cfg)
    return ft, synthetic.exact_u(ft)
