"""Compute kernels: torch ops, plus hand-written Hopper kernels under ``cuda/``."""
