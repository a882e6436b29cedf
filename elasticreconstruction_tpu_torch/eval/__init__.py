"""Evaluation: trajectory error (ATE), the ground-truth pair benchmark and
registration precision/recall, as the reference's Matlab toolbox scores them."""

from . import ate, gt_benchmark, registration_pr

__all__ = ["ate", "gt_benchmark", "registration_pr"]
