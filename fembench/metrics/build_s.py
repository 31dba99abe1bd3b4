"""build_s (s, program span): the host build of the mesh and the problem,
the port's timing registry's stages from the mesh to the assembled
matrix and vector (tpufem_torch/timing.py)."""

STAGES = ("ZZZ Create Mesh", "ZZZ Create facets and facet->cell connectivity",
          "ZZZ FunctionSpace", "ZZZ Create boundary conditions",
          "ZZZ Assemble matrix", "ZZZ Assemble vector")


def read(record):
    found = [record["registry"][s] for s in STAGES if s in record["registry"]]
    return sum(found) if found else None
