"""The synthetic analytic tables in the fast (log-uniform u) form."""
from h100bench.gen import synthetic


def make(cfg: dict):
    return synthetic.fast_tables(cfg), None
