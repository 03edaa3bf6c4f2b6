"""PyTorch/CUDA port of the `repro` package.

The JAX package under ``src/repro`` is the reference; this package keeps its
module names and public signatures so each counterpart is easy to find.  It
imports torch and numpy only -- never jax and nothing of ``repro`` -- and its
entry points run on the CUDA device unless the caller passes a CPU device.
"""
