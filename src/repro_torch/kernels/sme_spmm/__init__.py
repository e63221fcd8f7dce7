"""Plane-CSC (v3) SME kernels: one module per kernel, each holding the CUDA
wrapper (with its ``launches`` count) and its plain PyTorch version, plus
the shared scaffolding in ``csc_grid``."""
