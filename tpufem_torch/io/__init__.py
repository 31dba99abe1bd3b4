"""Output of the mesh and the solution (counterpart of tpufem/io)."""

from tpufem_torch.io.xdmf import (import_h5py, read_xdmf,  # noqa: F401
                                  write_xdmf, xdmf_datasets)
