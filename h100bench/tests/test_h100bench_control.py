"""The check fails what it must: the control (one precision below the
configuration's, in the program's place) and the faults the cells can
have, each planted in the program under a run whose look for a card is
skipped; the sound program passes beside them."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h100bench import harness
from h100bench.reference.forward import Reference
from h100bench.tests import tinycell

FORMOD = ["limb_flagship.formod", "limb_wide_exact.formod"]
ALL = FORMOD + ["limb_wide_exact.jacobian"]


@pytest.mark.parametrize("workload", ALL)
def test_sound_program_passes(workload):
    assert tinycell.run(workload)["correct"]


@pytest.mark.parametrize("workload", ALL)
def test_control_fails(workload, monkeypatch):
    w, cfg, traffic, limits = tinycell.spec(workload)
    if cfg["dtype"] == "float64":
        # the program's own float32 path
        sp = (w, dict(cfg, dtype="float32"), traffic, limits)
        r = tinycell.run(workload, sp=sp)
    else:
        # float32 stated: the reference with bfloat16 tables and LOS in
        # the program's place
        def call(self, i):
            if not hasattr(self, "low"):
                self.low = Reference(self.cfg, self.inp.ft, self.inp.u,
                                     torch.device("cpu"), torch.float32,
                                     storage=torch.bfloat16)
            self.kept += self.low.formod([self.atm(i)], self.inp.geo,
                                         self.inp.rows)
        monkeypatch.setattr(harness.module("entries", "formod").Entry, "call",
                            call)
        r = tinycell.run(workload, sp=(w, cfg, traffic, limits))
    assert not r["correct"]
    assert any(v["value"] > v["limit"] for v in r["check"].values())


def _formod_fault(monkeypatch, fault: str):
    from jurassic_torch.forward import ForwardModel, RtOut
    integrate, packages = (ForwardModel._integrate_deferred,
                           ForwardModel._run_packages)

    def pass_(self, los):
        out, taint = integrate(self, los)
        if fault == "state unchanged":
            out = RtOut(rad=torch.zeros_like(out.rad),
                        tau=torch.ones_like(out.tau))
        elif fault == "answer altered":
            rad = out.rad.clone()
            rad[:, 0] *= 1.01
            out = RtOut(rad=rad, tau=out.tau)
        return out, taint

    def loop(self, obs, pack, trace):
        packages(self, obs, pack, trace)
        h = obs.nr // 2
        obs.rad[h:] = obs.rad[:h].mean(axis=0)
        obs.tau[h:] = obs.tau[:h].mean(axis=0)
    monkeypatch.setattr(ForwardModel, "_integrate_deferred", pass_)
    if fault == "half of the batch left out":
        monkeypatch.setattr(ForwardModel, "_run_packages", loop)


def _jacobian_fault(monkeypatch, fault: str):
    from jurassic_torch import retrieval
    from jurassic_torch.forward import ForwardModel
    if fault == "state unchanged":
        jvp = ForwardModel.integrate_jvp

        def tangents(self, los, tan):
            out, drad = jvp(self, los, tan)
            return out, torch.zeros_like(drad)
        monkeypatch.setattr(ForwardModel, "integrate_jvp", tangents)
        return
    kernel = retrieval.kernel_autodiff

    def k(ctl, atm, obs, model):
        K = kernel(ctl, atm, obs, model).reshape(obs.nr, ctl.nd, -1).copy()
        if fault == "answer altered":
            K *= 1.01
        else:
            h = obs.nr // 2
            K[h:] = K[:h].mean(axis=0)
        return K.reshape(obs.nr * ctl.nd, -1)
    monkeypatch.setattr(retrieval, "kernel_autodiff", k)


@pytest.mark.parametrize("fault", ["state unchanged",
                                   "half of the batch left out",
                                   "answer altered"])
@pytest.mark.parametrize("workload", ALL)
def test_fault_fails(workload, fault, monkeypatch):
    """The faults of a single-chip cell (no exchange between chips)."""
    if workload in FORMOD:
        _formod_fault(monkeypatch, fault)
    else:
        _jacobian_fault(monkeypatch, fault)
    r = tinycell.run(workload)
    assert not r["correct"]
    assert np.isfinite(list(v["limit"] for v in r["check"].values())).all()
