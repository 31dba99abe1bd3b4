"""XDMF/HDF5 output of mesh + solution (the port's copy of
tpufem/io/xdmf.py: the same XML, datasets and attributes).

Equivalent of ``dolfinx::io::XDMFFile::write_mesh/write_function``
(reference call site: src/main.cpp:213-223, gated by --output).  Writes
an XDMF3 XML index referencing heavy data in an HDF5 sidecar (h5py,
imported only when a file is written or read).

Fidelity: the XDMF ``Attribute`` holds the function at mesh vertices
(for Lagrange spaces these are exact point values — the P1 "rendering"
common visualization tools expect).  For order >= 2 the FULL dof vector
is additionally written verbatim to ``/function/dofs`` together with
``/function/dof_coords`` (point-evaluation coordinates of every scalar
dof) and the cell->dof connectivity, so no information is lost: a
reader can reconstruct the exact finite-element function.
``read_xdmf`` round-trips everything back.  ``u`` is a host vector in
the space's dof order, node-interleaved (``bs * node + c``) for a
vector space.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


_XDMF_TEMPLATE = """<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0" xmlns:xi="https://www.w3.org/2001/XInclude">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology TopologyType="Tetrahedron" NumberOfElements="{ncells}">
        <DataItem Dimensions="{ncells} 4" NumberType="Int" Format="HDF">{h5name}:/mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="XYZ">
        <DataItem Dimensions="{nverts} 3" Format="HDF">{h5name}:/mesh/geometry</DataItem>
      </Geometry>
      <Attribute Name="{attr_name}" AttributeType="{attr_type}" Center="Node">
        <DataItem Dimensions="{nverts} {attr_dim}" Format="HDF">{h5name}:/function/values</DataItem>
      </Attribute>
    </Grid>
  </Domain>
</Xdmf>
"""


def import_h5py():
    """h5py, imported where a file is written or read (and by the CLI
    before a run that will write one)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("--output writes its heavy data with h5py, which "
                          "this Python cannot import") from e
    return h5py


def xdmf_datasets(mesh, u: Optional[np.ndarray] = None, bs: int = 1,
                  space=None) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """The HDF5 datasets (path -> array, in the order written) and root
    attributes :func:`write_xdmf` writes: all its host work but the
    file."""
    nverts = mesh.num_vertices_global
    data = {"/mesh/topology": np.asarray(mesh.cells(), dtype=np.int64),
            "/mesh/geometry": mesh.vertex_coords(np.arange(nverts,
                                                           dtype=np.int64))}
    attrs: Dict[str, int] = {}
    if u is not None:
        vals = np.asarray(u)
        full = vals.reshape(-1, bs) if bs > 1 else vals.reshape(-1, 1)
        data["/function/values"] = full[:nverts]
        attrs["order"] = 1 if space is None else int(space.order)
        attrs["bs"] = int(bs)
        if space is not None and space.order >= 2:
            # full-order fidelity: verbatim dofs + their coordinates
            # + cell->dof map (enough to evaluate the FE function
            # anywhere; see reference src/main.cpp:218-222 where the
            # XDMFFile writes the full Function)
            data["/function/dofs"] = full
            data["/function/dof_coords"] = space.scalar_dof_coords()
            data["/function/cell_dofs"] = np.asarray(space.cell_dofs,
                                                     dtype=np.int64)
    return data, attrs


def write_xdmf(filename: str, mesh, u: Optional[np.ndarray] = None,
               bs: int = 1, name: str = "u", space=None) -> None:
    """Write mesh (+ optional nodal function) to ``filename`` (.xdmf)
    with an HDF5 sidecar next to it.

    ``space`` (a :class:`tpufem_torch.fem.space.FunctionSpace`) enables the
    full-order datasets for order >= 2; without it only the vertex
    values are stored (exact for order 1)."""
    base, _ = os.path.splitext(filename)
    h5path = base + ".h5"
    h5name = os.path.basename(h5path)
    data, attrs = xdmf_datasets(mesh, u, bs, space)

    h5py = import_h5py()
    with h5py.File(h5path, "w") as f:
        for path, arr in data.items():
            f.create_dataset(path, data=arr)
        for key, val in attrs.items():
            f.attrs[key] = val

    xml = _XDMF_TEMPLATE.format(
        ncells=data["/mesh/topology"].shape[0],
        nverts=mesh.num_vertices_global, h5name=h5name,
        attr_name=name, attr_type="Vector" if bs > 1 else "Scalar",
        attr_dim=bs)
    with open(filename, "w") as f:
        f.write(xml)


def read_xdmf(filename: str) -> dict:
    """Re-read an xdmf/h5 pair written by :func:`write_xdmf`.

    Returns a dict with ``topology``, ``geometry``, ``values`` (vertex
    values, [nverts, bs]) and — when present — ``dofs`` ([ndofs, bs]),
    ``dof_coords``, ``cell_dofs``, ``order``, ``bs``."""
    base, _ = os.path.splitext(filename)
    h5path = base + ".h5"
    h5py = import_h5py()
    out = {}
    with h5py.File(h5path, "r") as f:
        out["topology"] = f["/mesh/topology"][()]
        out["geometry"] = f["/mesh/geometry"][()]
        if "/function/values" in f:
            out["values"] = f["/function/values"][()]
            out["order"] = int(f.attrs.get("order", 1))
            out["bs"] = int(f.attrs.get("bs", 1))
        for key in ("dofs", "dof_coords", "cell_dofs"):
            if f"/function/{key}" in f:
                out[key] = f[f"/function/{key}"][()]
    return out
