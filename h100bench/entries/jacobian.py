"""``jacobian``: ``jurassic_torch.retrieval.kernel_autodiff`` at a fresh
pooled linearisation point each call.  The work of a call is the entries
of K (n x rays x channels); its answer K, compared as ``k_gap``."""
import numpy as np

from h100bench import check, program

# the calls into each layer, as spans of a traced run (tracing.spans)
SPANS = (
    ("jurassic_torch.retrieval", None, "autodiff_seed", "state map seed"),
    ("jurassic_torch.retrieval", None, "package_tangents",
     "package tangents"),
    ("jurassic_torch.geometry", None, "trace_rays_jvp", "tracer tangents"),
    ("jurassic_torch.forward", "ForwardModel", "integrate_jvp",
     "RT tangents"),
)


class Entry(program.Entry):

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        from jurassic_torch.retrieval import atm2x
        self.obs = program.program_obs(self.inp.geo, self.ctl.nd)
        x0, _, _ = atm2x(self.ctl, program.program_atm(self.inp.pool[0]))
        self.work = x0.size * self.inp.nr * self.ctl.nd

    def call(self, i: int) -> None:
        from jurassic_torch.retrieval import kernel_autodiff
        K = kernel_autodiff(self.ctl, program.program_atm(self.atm(i)),
                            self.obs, self.model)
        R, D = self.inp.nr, self.ctl.nd
        self.kept.append(np.array(K.reshape(R, D, -1)[self.inp.rows]))


def compare(reference, atms: list, geo: dict, rows, got: list) -> dict:
    return check.jacobian_numbers(got, reference.jacobian(atms, geo, rows),
                                  check.state_blocks(reference, atms[0]))
