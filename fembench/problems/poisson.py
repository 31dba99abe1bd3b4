"""Problem type ``poisson``: tpufem_torch's assembled Poisson system on
the cube (``tpufem_torch.problems.poisson``), solved by its CG with the
configured preconditioner; the traced stretch wraps each call of the
preconditioner (``Solver.precond``, the V-cycle under ``-pc_type gmg``)
in the range ``fembench.vcycle``."""

from fembench import port


def build(config: dict, mix: dict, device):
    mesh, problem = port.build_cube(config, mix, device)
    return port.Subject(mesh, problem, hook="precond",
                        range_name="fembench.vcycle")
