"""Print the 64-bit string hash of an argument (mirror of hash.c).

Usage: ``python -m jurassic_torch.cli.strhash <string>``

The reference's binary-table cache tags each stored variable name with
a djb2 string hash (jr_simple_string_hash.h:6-15, used by
jr_binary_tables_io.h:86) and ships a tiny CLI to compute it for
debugging (hash.c:31-35).  The port's npz table cache keys on
sha256 content digests instead (tables.py), so this CLI exists purely
for drop-in CLI-set parity: it prints the same value the reference
prints for the same string, using the classic public-domain djb2
recurrence (h = h*33 + byte, seed 5381) truncated to 64 bits.

The port's own copy of ``jurassic_tpu/cli/strhash.py``.
"""
from __future__ import annotations

import sys

from ._common import cli_main, die


def djb2_64(s: str) -> int:
    h = 5381
    for b in s.encode():
        h = (h * 33 + b) & 0xFFFFFFFFFFFFFFFF
    return h


@cli_main
def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2:
        die("usage: hash <string>")
    print("0x%x" % djb2_64(argv[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
