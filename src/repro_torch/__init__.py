"""PyTorch port of the SME reproduction, for NVIDIA Hopper.

Mirrors ``repro``'s module layout; each module names the reference file
it is checked against.  Imports ``torch`` and numpy only, never ``jax`` or
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
