"""Tensor primitives of the port: the MSDA core, its CUDA kernel, transforms."""
