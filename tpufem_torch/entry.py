"""One matrix-free Poisson apply, the hot step of the cgpoisson path: the
port's twin of the repository's ``__graft_entry__.entry()``.

``entry()`` builds P2 on an 8^3 ``BoxTetMesh`` with the Poisson
Dirichlet planes, tpufem's matrix-free operator (fem.matfree_op: the
metric, the cell dofs and the scatter plan, float32) and x from
``numpy.random.default_rng(0)``, and returns ``(fn, (op, x))`` with
``fn(op, x) = op.apply(x)``: on the card one launch of the matrix-free
kernel, on the CPU its plain version.

    python -c "from tpufem_torch.entry import entry; fn, a = entry(); \\
        print(fn(*a).norm())"
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.fem.dirichlet import DirichletBC
from tpufem_torch.fem.matfree_op import MatFreePoissonOp
from tpufem_torch.fem.space import FunctionSpace
from tpufem_torch.mesh.structured import BoxTetMesh
from tpufem_torch.problems import common


def entry(device: Optional[torch.device] = None
          ) -> Tuple[Callable, Tuple[MatFreePoissonOp, torch.Tensor]]:
    """``(fn, (op, x))`` on ``device`` (default: the current CUDA
    device; there is no fallback to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("entry(): no CUDA device (pass device='cpu' "
                               "for the plain version)")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    box = BoxTetMesh(8, 8, 8)
    space = FunctionSpace(box, 2)
    bc = DirichletBC.from_space(
        space, box.locate_boundary_facets(common.poisson_bc_marker))
    op = MatFreePoissonOp.build(space, bc, torch.float32, device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        space.ndofs_scalar).astype(np.float32)).to(device)

    def fn(op: MatFreePoissonOp, x: torch.Tensor) -> torch.Tensor:
        return op.apply(x)

    return fn, (op, x)
