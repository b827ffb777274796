"""Tensor ops of the port: plain functions plus the kernel wrappers."""
