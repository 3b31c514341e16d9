"""PyTorch/CUDA port of the ``repro`` package, slice by slice.

Module paths and public names mirror ``src/repro/``; the JAX package is
the reference this port is tested against.  This package imports
``torch``, ``numpy`` and the standard library only.
"""
