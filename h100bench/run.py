"""Run one cell of the benchmark of ``jurassic_torch`` on the H100:

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers the check compared, each beside its limit,
are the last lines of standard error.  Without a CUDA card, or with
fewer cards than the cell asks for, it exits with code 2 and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    cache = Path(__file__).resolve().parent / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    # one host thread for the host's numerical libraries: with PyTorch's
    # default pool of a thread per core, the host-paced flagship's rate
    # spread 30-40 % from run to run on the card's 8-core machine; with
    # one, 2 % (and no run was slower)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    torch.set_num_threads(1)
    from .harness import run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
