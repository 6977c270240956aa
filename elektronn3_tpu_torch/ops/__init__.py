"""Fused level ops (``fused``) and the loader of their CUDA kernels
(``_build``). Importing builds nothing: kernels are compiled at their
first launch."""
