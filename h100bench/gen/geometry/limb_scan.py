"""A limb scan from one observer (``obsz``; tangent heights ``scan_z0``
to ``scan_z1`` every ``scan_dz`` km)."""
from h100bench.gen import synthetic


def make(cfg: dict) -> dict:
    return synthetic.limb_scan(cfg)
