"""The program's synthetic midlatitude atmosphere (levels every
``atm_dz`` km up to ``atm_ztop``)."""
from h100bench.gen import synthetic


def make(cfg: dict) -> dict:
    return synthetic.atmosphere(cfg)
