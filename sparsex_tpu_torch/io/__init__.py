"""Input loaders: MatrixMarket files and CSR views (the port's copy of
``sparsex_tpu/io``)."""

from sparsex_tpu_torch.io.mmf import MMF, load_mmf
from sparsex_tpu_torch.io.csr import CSR

__all__ = ["MMF", "load_mmf", "CSR"]
