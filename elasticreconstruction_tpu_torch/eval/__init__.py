"""Evaluation: trajectory error (ATE), the ground-truth pair benchmark and
registration precision/recall, as the reference's Matlab toolbox scores them;
and the synthetic benchmark's scores of the elastic modes: a learned lattice
against the injected distortion, and surface error against the scene SDF."""

from . import ate, gt_benchmark, lattice_recovery, registration_pr, surface_error

__all__ = ["ate", "gt_benchmark", "lattice_recovery", "registration_pr", "surface_error"]
