"""grail_torch — the PyTorch/CUDA port of grail, the wavefront path tracer.

The JAX package `grail` stays the reference; this package mirrors its layout
(core/, scene/, shade/, kernels/, engine/) and is held against it by the
`tests/test_torch_*.py` parity tests. It imports torch and numpy only.
"""
