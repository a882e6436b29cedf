"""A run with the timed path broken underneath comes out not correct; the unbroken run comes out correct.

Each run skips the harness's look for a card (``device="cpu"``) and runs the
rest at toy size: set-up, a window of one call, the judge. One fault a test,
each planted where the program produces it: a step that returns its state
unchanged, half of the batch left out, an answer altered. (No cell has an
exchange between chips to leave out.)
"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import toy


def _run(cell):
    out = harness.run_cell(cell, toy.SEED, 0.01, False, t_start=time.perf_counter(), device="cpu",
                           overrides=toy.CELLS[cell])
    assert out["attempted"] >= 1
    return out


@pytest.mark.parametrize("cell", sorted(toy.CELLS))
def test_the_unbroken_program_is_correct(cell):
    assert _run(cell)["correct"]


def _odometry_state_unchanged(mp):
    from elasticreconstruction_tpu_torch.odometry import fragments, kinfu

    real = fragments.track_frame

    def frozen(vol, depth, init_pose, intr, cfg):
        return real(vol, depth, init_pose, intr, cfg)._replace(pose=init_pose)

    mp.setattr(fragments, "track_frame", frozen)
    del kinfu


def _odometry_half_left_out(mp):
    from elasticreconstruction_tpu_torch.odometry import fragments

    real, seen = fragments._tsdf.fuse, []

    def every_other(vol, *a, **k):
        seen.append(1)
        return vol if len(seen) % 2 == 0 else real(vol, *a, **k)

    mp.setattr(fragments._tsdf, "fuse", every_other)


def _odometry_answer_altered(mp):
    from elasticreconstruction_tpu_torch.odometry import fragments

    real = fragments.track_frame

    def nudged(*a, **k):
        r = real(*a, **k)
        return r._replace(pose=r.pose + torch.tensor([[0, 0, 0, 1e-3]] + [[0, 0, 0, 0]] * 3, dtype=r.pose.dtype))

    mp.setattr(fragments, "track_frame", nudged)


def _register_state_unchanged(mp):
    from elasticreconstruction_tpu_torch.registration import pair

    real = pair._icp.icp_point_to_plane_batch

    def no_steps(*a, **k):
        return real(*a, **dict(k, iterations=0, coarse_iterations=0))

    mp.setattr(pair._icp, "icp_point_to_plane_batch", no_steps)


def _register_half_left_out(mp):
    from elasticreconstruction_tpu_torch.registration import pair

    real = pair._register_core

    def half(*a):
        r = real(*a)
        b = r.transform.shape[0]
        keep = torch.arange(b) < (b + 1) // 2
        eye = torch.eye(4).expand(b, 4, 4)
        return r._replace(transform=torch.where(keep[:, None, None], r.transform, eye),
                          information=r.information * keep[:, None, None], fitness=r.fitness * keep,
                          success=r.success & keep)

    mp.setattr(pair, "_register_core", half)


def _register_answer_altered(mp):
    from elasticreconstruction_tpu_torch.registration import pair

    real = pair._register_core

    def nudged(*a):
        r = real(*a)
        shift = torch.zeros(4, 4)
        shift[0, 3] = 1e-3
        return r._replace(transform=r.transform + shift)

    mp.setattr(pair, "_register_core", nudged)


FAULTS = {
    "odometry.livingroom_full_640": [_odometry_state_unchanged, _odometry_half_left_out, _odometry_answer_altered],
    "register.livingroom_full_640": [_register_state_unchanged, _register_half_left_out, _register_answer_altered],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"] and out["failed"] >= 1, out["checks"]
