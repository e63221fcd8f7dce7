"""SME CSC-of-tiles kernels: one module per kernel (v1 ``sme_spmm``, v2
``sme_spmm6``, v3 ``sme_spmm_planes`` and ``sme_spmm_planes_decode``), each
holding the CUDA wrapper (with its ``launches`` count) and its plain
PyTorch version; the shared scaffolding in ``csc_grid``, the numpy oracles
in ``ref`` and the kernel-level convenience wrappers in ``ops``."""
