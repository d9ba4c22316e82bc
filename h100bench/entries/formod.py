"""``formod``: ``jurassic_torch.forward.ForwardModel.formod`` over every
ray of the scan, a fresh pooled atmosphere each call.  The work of a call
is rays x channels; its answer the radiance and transmittance of every
ray and channel, compared as ``rad_gap`` and ``tau_gap``."""
from h100bench import check, program

# the calls into each layer, as spans of a traced run (tracing.spans)
SPANS = (
    ("jurassic_torch.forward", None, "hydrostatic_atm", "hydrostatics"),
    ("jurassic_torch.forward", None, "build_ray_profiles", "ray profiles"),
    ("jurassic_torch.forward", None, "trace_rays_deferred", "tracer launch"),
    ("jurassic_torch.forward", "ForwardModel", "_integrate_deferred",
     "RT pass launch"),
    ("jurassic_torch.forward", "ForwardModel", "outputs_to_host_many",
     "device to host"),
    ("jurassic_torch.forward", None, "formod_fov", "FOV and mask"),
)


class Entry(program.Entry):

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.obs = program.program_obs(self.inp.geo, self.ctl.nd)
        self.rad0 = self.obs.rad
        self.work = self.inp.nr * self.ctl.nd

    def call(self, i: int) -> None:
        # formod replaces obs.rad; each call starts from finite zeros, as
        # an observation whose radiances are all measured
        self.obs.rad = self.rad0
        self.model.formod(program.program_atm(self.atm(i)), self.obs)
        rows = self.inp.rows
        self.kept.append((self.obs.rad[rows].copy(),
                          self.obs.tau[rows].copy()))


def compare(reference, atms: list, geo: dict, rows, got: list) -> dict:
    return check.formod_numbers(got, reference.formod(atms, geo, rows))
