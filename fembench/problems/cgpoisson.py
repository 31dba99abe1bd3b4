"""Problem type ``cgpoisson``: tpufem_torch's matrix-free CG Poisson on
the cube (``tpufem_torch.problems.cgpoisson``), unpreconditioned CG on
the operator's action; the traced stretch wraps each call of the action
(``Solver.apply``) in the range ``fembench.apply``."""

from fembench import port


def build(config: dict, mix: dict, device):
    mesh, problem = port.build_cube(config, mix, device)
    return port.Subject(mesh, problem, hook="apply",
                        range_name="fembench.apply")
