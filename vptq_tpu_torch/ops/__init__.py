"""Kernels and tensor ops of the port."""
