"""Whether ``torch.profiler`` records a ``formod`` that follows the
profile of an eager loop of some 10^5 launches, and what changes that.

Each case runs in a process of its own (the profiler's state is the
process's): the flagship's geometry on its first RAYS rays under
``KERNEL = jax`` in float32 (the eager loop launches about 1.9 x 10^5
kernels whatever the ray count), then

  1. the eager loop (``ForwardModel.integrate_eager``), profiled or not;
  2. ten launches of the RT kernel timed by CUDA events
     (``ega_fused.LAUNCH_EVENTS``), as ``chip_smoke.py`` times them;
  3. two profiled ``formod`` calls, each with its device activities and
     its RT kernel launches counted from the profiler's raw records.

The cases: ``default``; ``teardown0`` (``TEARDOWN_CUPTI=0`` in the
environment: torch then keeps CUPTI alive between profiler sessions);
``unprofiled`` (the loop runs without the profiler); ``short`` (the
loop profiled on the first 4 segments of the LOS, some 2 x 10^3
launches); ``gap`` (the default with a 5 s sleep and a garbage
collection between the loop's profile and the formod's); ``nccl`` (an
NCCL process group of one, an all-reduce and its destruction before
step 1, as ``chip_smoke.py``'s multi-GPU phase leaves the process) and
``nccl_teardown0`` (the same with ``TEARDOWN_CUPTI=0``); ``sessions``
(twenty profiled ``formod`` calls before step 1); ``flagship`` and
``flagship_teardown0`` (all 1084 rays, so that the loop's kernels take
the device as long as ``chip_smoke.py``'s do); ``rt_phase`` and
``rt_phase_teardown0`` (``chip_smoke.py``'s phase "RT kernel" itself in
a fresh process, from the checkout's ``chip_smoke.py``: the attempts
each profiled call took).

Run on a machine with a card, from the repository root::

    python -m jurassic_torch.tools.profile_probe [--cases A,B] [--out FILE]
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

RAYS = 16
CASES = {"default": {}, "teardown0": {"TEARDOWN_CUPTI": "0"},
         "unprofiled": {}, "short": {}, "gap": {}, "nccl": {},
         "nccl_teardown0": {"TEARDOWN_CUPTI": "0"}, "sessions": {},
         "flagship": {}, "flagship_teardown0": {"TEARDOWN_CUPTI": "0"},
         "rt_phase": {}, "rt_phase_teardown0": {"TEARDOWN_CUPTI": "0"}}


def device_activities(prof) -> list:
    """(name, ns) of every device activity a finished profile recorded,
    from its raw Kineto events."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def profiled(fn):
    """(device activities, RT kernel launches among them) of ``fn()``
    under torch.profiler, CUDA activity only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = device_activities(prof)
    return len(ks), sum("ega_rt_kernel" in k[0] for k in ks)


def run_case(case: str) -> dict:
    import torch

    from ..forward import ForwardModel, _obs_rows
    from ..ops import ega_fused
    from ..workloads import flagship
    dev = torch.device("cuda", 0)
    if case.startswith("rt_phase"):
        import importlib.util
        root = Path(__file__).resolve().parents[2]
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", root / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        smoke.rt_kernel_phase(torch, ForwardModel, flagship, dev,
                              {"max_abs_err": 0.0})
        return {"case": case, "env": CASES[case],
                "attempts": smoke.PROFILE_ATTEMPTS}
    ctl, ft, atm, obs = flagship()
    ctl.usetpu, ctl.kernel = 1, "jax"
    if not case.startswith("flagship"):
        obs = _obs_rows(obs, slice(0, RAYS))
    m = ForwardModel(ctl, fast_tables=ft, device=dev, dtype=torch.float32)
    los = m.trace(atm.copy(), obs.copy())
    m.formod(atm.copy(), obs.copy())             # builds, warms up
    loop_los = los
    if case == "short":
        loop_los = los._replace(**{f: getattr(los, f)[:, :4].contiguous()
                                   for f in ("z", "lon", "lat", "p", "t",
                                             "q", "k", "ds", "u", "valid")})
    out = {"case": case, "env": CASES[case]}
    if case.startswith("nccl"):
        import socket

        import torch.distributed as dist
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
        x = torch.ones(4, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        dist.destroy_process_group()
    if case == "sessions":
        out["sessions"] = [profiled(lambda: m.formod(atm.copy(), obs.copy()))
                           for _ in range(20)]
    if case == "unprofiled":
        m.integrate_eager(loop_los)
        torch.cuda.synchronize()
    else:
        out["loop"] = profiled(lambda: m.integrate_eager(loop_los))
    ega_fused.LAUNCH_EVENTS = []
    for _ in range(10):
        m.integrate(los)
    torch.cuda.synchronize()
    ega_fused.LAUNCH_EVENTS = None
    if case == "gap":
        gc.collect()
        time.sleep(5.0)
    out["formod"] = [profiled(lambda: m.formod(atm.copy(), obs.copy()))
                     for _ in range(2)]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated cases to run (default: all)")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON result to this file")
    ns = ap.parse_args()
    if ns.case is not None:
        print(json.dumps(run_case(ns.case)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_probe: needs a CUDA device")
    results = []
    for case in ns.cases.split(","):
        env = CASES[case]
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "jurassic_torch.tools.profile_probe",
             "--case", case], capture_output=True, text=True,
            env={**os.environ, **env})
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        got = json.loads(lines[-1]) if res.returncode == 0 and lines else {
            "case": case, "error": res.stderr[-2000:]}
        got["seconds"] = round(time.perf_counter() - t0, 1)
        results.append(got)
        print(json.dumps(got), flush=True)
    line = json.dumps(results)
    if ns.out is not None:
        ns.out.parent.mkdir(parents=True, exist_ok=True)
        ns.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
