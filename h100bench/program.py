"""The program under test as the entries drive it: the benchmark's plain
inputs made into the program's own objects, and the base of an entry.

An entry is a file ``entries/<entry>.py``, named by a mix's ``"entry"``
(``traffic/<mix>.json``), with a class ``Entry`` (this module's
:class:`Entry` with its ``work`` per call and ``call(i)``) and
``compare(reference, atms, geo, rows, got)``, which returns the compared
numbers (``check``) of the answers ``got`` that it kept.  Each entry
keeps, of every call in the window, the answers of the rays the check
compares (``gen.check_sample``).  ``precision`` names the program's own
lower-precision path for the control (the model in float32 where the
configuration states float64).
"""
from __future__ import annotations

from pathlib import Path

import torch

from .gen import synthetic

DTYPES = {"float32": torch.float32, "float64": torch.float64}
CACHE = Path(__file__).resolve().parent / ".cache"


def program_ctl(cfg: dict, device: torch.device, kernel=None):
    """The program's control of the configuration; its ``ctl`` object,
    where given, sets further fields of the program's control by name."""
    from jurassic_torch.config import ctl_from_dict
    em = list(cfg["emitters"])
    ctm = cfg["continua"]
    ret = cfg["retrieval"]
    return ctl_from_dict(dict(
        emitter=em, nu=[float(x) for x in synthetic.channels(cfg)],
        tblbase="-", write_binary=0, read_binary=0,
        nlos=int(cfg["nlos"]), rayds=float(cfg["rayds"]),
        raydz=float(cfg["raydz"]), refrac=int(cfg["refrac"]),
        hydz=float(cfg["hydz"]), ctm_co2=int(ctm["co2"]),
        ctm_h2o=int(ctm["h2o"]), ctm_n2=int(ctm["n2"]),
        ctm_o2=int(ctm["o2"]), kernel=kernel or cfg["kernel"],
        usetpu=1 if device.type == "cuda" else 0,
        rett_zmin=float(ret["t_zmin"]), rett_zmax=float(ret["t_zmax"]),
        retq_zmin=[float(ret["q_zmin"])] * len(em),
        retq_zmax=[float(ret["q_zmax"])] * len(em), **cfg.get("ctl", {})))


def program_atm(a: dict):
    from jurassic_torch.io_tab import Atm
    atm = Atm.zeros(a["z"].size, a["q"].shape[0], a["k"].shape[0])
    for k in ("time", "z", "lon", "lat", "p", "t", "q", "k"):
        getattr(atm, k)[:] = a[k]
    return atm


def program_obs(geo: dict, nd: int):
    from jurassic_torch.io_tab import Obs
    obs = Obs.zeros(geo["vpz"].size, nd)
    for k, v in geo.items():
        getattr(obs, k)[:] = v
    return obs


def program_model(cfg: dict, inp, device: torch.device, dtype: torch.dtype):
    """The program's ``ForwardModel`` of the configuration: fast tables
    (a turbo fit for ``KERNEL = auto``, cached under ``.cache/turbo``)
    or, where the inputs carry u rows, the exact tables."""
    from jurassic_torch.forward import ForwardModel
    from jurassic_torch.tables import EgaTables, FastTables
    ctl = program_ctl(cfg, device)
    ft = FastTables(**inp.ft)
    if inp.u is not None:
        tables = EgaTables(np_=ft.np_, nt=ft.nt, nu=ft.nu, p=ft.p, t=ft.t,
                           u=inp.u, eps=ft.eps, sr=ft.sr, st=ft.st)
        return ForwardModel(ctl, tables, device=device, dtype=dtype)
    if cfg["kernel"] in ("auto", "turbo"):
        from jurassic_torch.ops.turbo_fit import build_turbo_tables_cached
        tt, stats = build_turbo_tables_cached(ft, CACHE / "turbo", device)
        return ForwardModel(ctl, fast_tables=ft, turbo_tables=tt,
                            turbo_stats=stats, device=device, dtype=dtype)
    return ForwardModel(ctl, fast_tables=ft, device=device, dtype=dtype)


class Entry:
    """One entry under load: ``call(i)`` runs the i-th call of the
    window on pooled input i mod pool and keeps the sampled answers;
    ``work`` is what one call does, in the unit of the mix's rate."""

    work = 0

    def __init__(self, cfg: dict, inp, device: torch.device,
                 precision: str | None = None):
        self.cfg, self.inp, self.device = cfg, inp, device
        self.dtype = DTYPES[precision or cfg["dtype"]]
        self.model = program_model(cfg, inp, device, self.dtype)
        self.ctl = self.model.ctl
        self.kept: list = []

    def atm(self, i: int) -> dict:
        return self.inp.pool[i % len(self.inp.pool)]

    def free(self) -> None:
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
