"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

Each wrapper sends a CPU tensor to its plain PyTorch version (``ref.py``)
and a CUDA tensor to its kernel; it never falls back from one to the
other.  ``_build`` compiles the kernels with ``nvcc`` at first use and
keeps the per-wrapper launch counts.
"""
