"""Where the RT kernels' primal parts from the eager pass by an ulp.

On the CUDA card, at the flagship (1084 limb rays, 100 channels, 4 gases,
NLOS 400, all four continua) on a LOS the tracer kernel traces, each RT
kernel's rad and tau (the record kernel ``ops.ega_jvp.
rt_jvp_records_cuda`` and, where the library has it, the primal kernel
``ops.ega_rt.rt_integrate_cuda``) are compared bit for bit with the eager
pass ``forward.rt_integrate`` on the same tensors: float64 on every ray,
float32 on every fourth, on channel-uniform and on per-channel axes
(``workloads.perturbed_axes``).  The lanes that are not bit for bit are
counted.

Then the search for the cause.  PyTorch's CUDA division by a Python
scalar is a product with the scalar's reciprocal
(``div_true_kernel_cuda``), ``s / t`` with a tensor ``t`` is
``t.reciprocal() * s`` (``Tensor.__rtruediv__``), and ``1 - 0.79`` is a
Python float a few ulps from 0.21.  A kernel that writes ``p / P0``,
``273 / t`` or 0.21 where the plain version has those does other
arithmetic.  The extinction's continua (``ops.continua.beta_ds``) hold
such places; ``KERNEL_FORM`` states each as the kernels wrote it before
this probe (``csrc/ega_jvp_fast.cu``'s ``continua``, the parent of the
header ``csrc/ega_rt_common.cuh``), in PyTorch operations that do what
the kernel did (a division by a tensor of the scalar is a real
division).  For each candidate alone the probe counts the (ray, segment,
channel) values of the extinction whose bits it changes; it runs the
eager pass with the extinction of all candidates in their kernel form
and says whether that pass gives the kernel's rad on every lane (then
the continua's statement is the whole cause); and on each lane where the
kernel parts from the eager pass it names the first segment at which the
kernel-form pass parts (the quantity: the extinction, exp(-bds), the
emissivity, then rad and tau) and the candidates that differ there.

With ``--parent ROOT`` (an earlier checkout, e.g. ``git archive <commit>
jurassic_torch | tar -x -C jurassic_torch/_build/parent``) it also runs
that checkout's record kernel on the same inputs, so that the count
before and after a fix is taken in one call.

Run on a machine with a card, from the repository root::

    python -m jurassic_torch.tools.ulp_probe [--parent ROOT] [--out FILE]
"""
from __future__ import annotations

import argparse
import importlib
import json
import threading
from pathlib import Path

import torch

from ..constants import NA, P0, TAU_CUTOFF
from ..forward import ForwardModel, rt_integrate, src_planck
from ..ops.ega import ega_eps_fast
from ..workloads import flagship, perturbed_axes

# the kernel's statement of each candidate place, before this probe
KERNEL_FORM = {
    "co2 / (NA 1000 P0)": "u_co2 p ctw / k0, a division",
    "h2o (296 - t) / 36": "a division by 36",
    "h2o p / P0": "a division by P0",
    "n2 mix (1 - 0.79)": "the constant 0.21",
    "n2 mix 0.4545 t / 296": "a division by 296",
    "n2o2 p / P0": "a division by P0",
    "n2o2 273 / t": "a division, not reciprocal(t) 273",
    "n2o2 product order": "((0.1 qgas) b) pr^2 tr^2 e mix",
}
N_LANES_SHOWN = 8


def _div(a, s: float):
    """``a / s`` as a real division (a tensor of the scalar)."""
    return a / torch.full_like(a, s)


def bds_forms(flags, cc, kw, ds, p, t, q, u_co2, u_h2o, kernel: set):
    """``beta_ds`` with the candidates in ``kernel`` in their kernel form
    (``KERNEL_FORM``) and the others as ``ops.continua`` writes them."""
    co2, h2o, n2, o2 = flags
    k = lambda name: name in kernel
    total = kw * ds
    if co2:
        dt230, dt260, dt296 = t - 230.0, t - 260.0, t - 296.0
        ctw = (dt260 * 5.050505e-4 * dt296 * cc.co2_cw230
               - dt230 * 9.259259e-4 * dt296 * cc.co2_cw260
               + dt230 * 4.208754e-4 * dt260 * cc.co2_cw296)
        x = u_co2 * p * ctw
        k0 = NA * 1000.0 * P0
        total = total + (_div(x, k0) if k("co2 / (NA 1000 P0)") else x / k0)
    if h2o:
        base = torch.where(cc.h2o_cw296 > 0, cc.h2o_cw260 / torch.where(
            cc.h2o_cw296 > 0, cc.h2o_cw296, 1.0), 1.0)
        ex = 296.0 - t
        ex = _div(ex, 36.0) if k("h2o (296 - t) / 36") else ex / 36.0
        ctwslf = cc.h2o_sfac * cc.h2o_cw296 * torch.pow(base, ex)
        a1 = cc.h2o_nu * u_h2o * torch.tanh(0.7193876 / t * cc.h2o_nu)
        a2 = 296.0 / t
        pr = _div(p, P0) if k("h2o p / P0") else p / P0
        a3 = pr * (q * ctwslf + (1 - q) * cc.h2o_ctwfrn) * 1e-20
        total = total + torch.where(cc.h2o_mask, a1 * a2 * a3, 0.0)
    for on, b, beta, qgas, mask in ((n2, cc.n2_b, cc.n2_beta, 0.79,
                                     cc.n2_mask),
                                    (o2, cc.o2_b, cc.o2_beta, 0.21,
                                     cc.o2_mask)):
        if not on:
            continue
        mix = 1.0
        if qgas == 0.79:
            c = 0.21 if k("n2 mix (1 - 0.79)") else 1 - 0.79
            x = 0.4545 * t
            x = _div(x, 296.0) if k("n2 mix 0.4545 t / 296") else x / 296.0
            mix = 0.79 + c * (1.294 - x)
        pr = _div(p, P0) if k("n2o2 p / P0") else p / P0
        tr = (torch.full_like(t, 273.0) / t if k("n2o2 273 / t")
              else 273.0 / t)
        e = torch.exp(beta * (1 / 296.0 - 1 / t))
        if k("n2o2 product order"):
            val = (torch.full_like(b, 0.1) * qgas * b * (pr * pr)
                   * (tr * tr) * e * mix)
        else:
            val = 0.1 * pr ** 2 * tr ** 2 * e * qgas * b * mix
        total = total + torch.where(mask, val, 0.0) * ds
    return total


def _step_inputs(m: ForwardModel, los, s: int):
    zq = torch.zeros_like(los.p[:, 0])
    q, u = los.q[:, s], los.u[:, s]
    e = m.eager_tables()
    kw = los.k[:, s][:, e.window]
    h = m.ig_h2o
    return (m.flags, e.cc, kw, los.ds[:, s, None], los.p[:, s, None],
            los.t[:, s, None], (q[:, h] if h >= 0 else zq)[:, None],
            (u[:, m.ig_co2] if m.ig_co2 >= 0 else zq)[:, None],
            (u[:, h] if h >= 0 else zq)[:, None])


def eager_pass(m: ForwardModel, los, kernel: set, lanes=None):
    """``forward.rt_integrate`` on the model's fast tables, the extinction
    from :func:`bds_forms` with ``kernel``'s candidates in kernel form;
    with ``lanes`` (ray, channel index tensors) also the per-segment
    (bds, exp(-bds), eps, rad, tau) of those lanes, each [S, n]."""
    e = m.eager_tables()
    R, S = los.ds.shape
    G, D = los.u.shape[2], m.sr.shape[1]
    dt, dev = los.p.dtype, los.p.device
    sr, st = m.sr.to(dt), m.st.to(dt)
    rad = torch.zeros((R, D), dtype=dt, device=dev)
    tau = torch.ones((R, D), dtype=dt, device=dev)
    tau_path = torch.ones((R, G, D), dtype=dt, device=dev)
    trail = []
    for s in range(S):
        valid = los.valid[:, s]
        bds = bds_forms(*_step_inputs(m, los, s), kernel)
        factor = ega_eps_fast(e.tbl, tau_path, los.t[:, s], los.u[:, s],
                              los.p[:, s])
        tau_gas = factor[:, 0]
        for g in range(1, G):
            tau_gas = tau_gas * factor[:, g]
        tau_path = torch.where(valid[:, None, None], tau_path * factor,
                               tau_path)
        src = src_planck(sr, st, los.t[:, s])
        ex = torch.exp(-bds)
        eps = 1.0 - tau_gas * ex
        upd = valid[:, None] & (tau_gas > TAU_CUTOFF)
        rad = torch.where(upd, rad + src * eps * tau, rad)
        tau = torch.where(upd, tau * (1.0 - eps), tau)
        if lanes is not None:
            trail.append(torch.stack([a[lanes] for a in (bds, ex, eps, rad,
                                                          tau)]))
    trail = torch.stack(trail, 1) if lanes is not None else None
    return rad, tau, trail


def probe_case(m: ForwardModel, los, parent=None) -> dict:
    """The holds and the search on one (model, LOS)."""
    from ..ops import ega_jvp as ej
    e = m.eager_tables()
    plain = rt_integrate(e.tbl, m.sr, m.st, m.nu, e.cc, e.window, los,
                         los.tsurf, m.flags, m.ig_co2, m.ig_h2o, True,
                         False)
    rargs = (e.tbl, m.sr, m.st, m.nu, e.cc, e.window, los, m.flags,
             m.ig_co2, m.ig_h2o, False)
    kernels = {"record": ej.rt_jvp_records_cuda(*rargs)[0]}
    try:
        from ..ops import ega_rt
        kernels["primal"] = ega_rt.rt_integrate_cuda(
            e.tbl, m.sr, m.st, m.nu, e.cc, e.window, los, m.flags,
            m.ig_co2, m.ig_h2o, False)
    except ImportError:
        pass
    if parent is not None:
        kernels["parent record"] = parent(rargs)
    torch.cuda.synchronize()
    out = {"lanes": plain.rad.numel()}
    for name, o in kernels.items():
        out[f"{name}: rad lanes off"] = int((o.rad != plain.rad).sum())
        out[f"{name}: tau lanes off"] = int((o.tau != plain.tau).sum())
    # each candidate alone: the extinction values whose bits it changes
    S = los.ds.shape[1]
    changed = {c: 0 for c in KERNEL_FORM}
    for s in range(S):
        args = _step_inputs(m, los, s)
        ref = bds_forms(*args, set())
        v = los.valid[:, s, None]
        for c in KERNEL_FORM:
            changed[c] += int(((bds_forms(*args, {c}) != ref) & v).sum())
    out["extinction values changed, per candidate alone"] = changed
    # the eager pass with every candidate in kernel form
    old = kernels.get("parent record", kernels["record"])
    off = (old.rad != plain.rad).nonzero()
    lanes = (off[:N_LANES_SHOWN, 0], off[:N_LANES_SHOWN, 1])
    rad_k, tau_k, trail_k = eager_pass(m, los, set(KERNEL_FORM), lanes)
    _, _, trail_p = eager_pass(m, los, set(), lanes)
    out["kernel-form eager pass: rad / tau lanes off the eager pass"] = [
        int((rad_k != plain.rad).sum()), int((tau_k != plain.tau).sum())]
    for name, o in kernels.items():
        out[f"kernel-form eager pass: rad / tau lanes off {name}"] = [
            int((rad_k != o.rad).sum()), int((tau_k != o.tau).sum())]
    shown = []
    names = ("bds", "exp(-bds)", "eps", "rad", "tau")
    for j in range(lanes[0].numel()):
        r, d = int(lanes[0][j]), int(lanes[1][j])
        differ = (trail_k[:, :, j] != trail_p[:, :, j])       # [5, S]
        lane = {"ray": r, "channel": d}
        for qi, qn in enumerate(names):
            hit = differ[qi].nonzero()
            lane[f"first segment where {qn} parts"] = (
                int(hit[0]) if hit.numel() else None)
        s0 = lane["first segment where bds parts"]
        if s0 is not None:
            args = [a[r:r + 1] if isinstance(a, torch.Tensor)
                    and a.dim() and a.shape[0] == los.p.shape[0]
                    else a for a in _step_inputs(m, los, s0)]
            ref = bds_forms(*args, set())[0, d]
            lane["candidates that change bds there"] = [
                c for c in KERNEL_FORM
                if bds_forms(*args, {c})[0, d] != ref]
            lane["bds plain / kernel form"] = [
                float(ref), float(bds_forms(*args, set(KERNEL_FORM))[0, d])]
        lane["rad plain / old kernel"] = [float(plain.rad[r, d]),
                                          float(old.rad[r, d])]
        shown.append(lane)
    out["lanes off (first shown)"] = shown
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", default=None)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ulp_probe: needs a CUDA card")
    dev = torch.device("cuda")
    from ..ops._build import load_library
    parent = None
    if ns.parent is not None:
        from .ega_split import load_parent
        load_parent(ns.parent.resolve())
        pb = importlib.import_module("jt_parent.ops._build")
        th = threading.Thread(target=pb.load_library)
        th.start()
        load_library()
        th.join()
        pej = importlib.import_module("jt_parent.ops.ega_jvp")
        pega = importlib.import_module("jt_parent.ops.ega")
        pgeo = importlib.import_module("jt_parent.geometry")
        pcon = importlib.import_module("jt_parent.ops.continua")

        def parent(rargs):
            tbl, sr, st, nu, cc, window, los, *rest = rargs
            ptbl = pega.FastDeviceTables(
                *tbl[:len(pega.FastDeviceTables._fields)])
            pcc = pcon.ContinuaCoeffs(*cc)
            plos = pgeo.LosData(*los)
            return pej.rt_jvp_records_cuda(ptbl, sr, st, nu, pcc, window,
                                           plos, *rest)[0]
    else:
        load_library()
    res = {"card": torch.cuda.get_device_name(0)}
    for dtype, every, axes in ((torch.float64, 1, "uniform"),
                               (torch.float64, 1, "per_channel"),
                               (torch.float32, 4, "uniform"),
                               (torch.float32, 4, "per_channel")):
        ctl, ft, atm, obs = flagship()
        if axes == "per_channel":
            ft = perturbed_axes(ft, seed=1)
        ctl.usetpu, ctl.kernel = 1, "jax"
        if every > 1:
            from ..forward import _obs_rows
            obs = _obs_rows(obs, slice(None, None, every))
        m = ForwardModel(ctl, fast_tables=ft, device=dev, dtype=dtype)
        los = m.trace(atm, obs)
        key = f"{str(dtype)[6:]}, {axes} axes, every {every}. ray"
        res[key] = probe_case(m, los, parent)
        print(f"{key}: {json.dumps(res[key])}", flush=True)
        del m, los
        torch.cuda.empty_cache()
    if ns.out:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
