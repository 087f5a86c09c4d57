"""Sampling math and the kernels of the port."""
