"""Kernels, linear algebra and quadrature, with the CUDA kernel and its build."""
