"""tpufem_torch — the PyTorch + CUDA port of tpufem.

Its slices, on the structured Kuhn cube mesh:

- Poisson P1, assembled as a 15-diagonal stencil, solved by CG
  preconditioned with geometric multigrid, and certified against a
  float64 host twin;
- the matrix-free ``cgpoisson`` problem, P1-P3: unpreconditioned
  Chronopoulos-Gear CG on the stencil (P1) or the channel-strip
  operator (P2/P3), or as one whole-CG kernel (``-cg_kernel on``).

The kernels are CUDA written for Hopper: the P1 stencil
(``csrc/stencil_p1.cu``), the strip stencil (``csrc/strip_apply.cu``)
and the whole CG (``csrc/strip_cg.cu``); every other device operation
is plain PyTorch.

The layout mirrors ``tpufem`` module by module (``fem/dia_op.py`` <->
``tpufem/fem/dia_op.py`` and so on).  ``tpufem`` stays the reference the
port is tested against; the port imports nothing of it and never
``jax``: it keeps its own copies of tpufem's jax-free host modules
(``mesh/structured.py``, ``fem/reference.py``, ``fem/space.py``,
``config.py``, ``logutil.py``, the timing registry, argument parsing).

Every function that touches tensors takes an explicit ``device``; there
is no default device and no fallback from CUDA to the CPU.

Run:  python -m tpufem_torch --problem_type poisson --ndofs 500000 \\
          --scaling_type strong --device cuda
"""

__version__ = "0.1.0"
