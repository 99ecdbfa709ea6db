"""Kernels of the port: plain versions, CUDA wrappers and their dispatch."""
