"""Convert radiance to brightness temperature (mirror of brightness.c).

Usage: ``python -m jurassic_torch.cli.brightness <rad> <nu>``

The port's own copy of ``jurassic_tpu/cli/brightness.py``.
"""
from __future__ import annotations

import sys

from ..ops.planck import brightness
from ._common import cli_main, die


@cli_main
def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 3:
        die("Give parameters: <rad> <nu>")
    print("%.10g" % brightness(float(argv[1]), float(argv[2])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
