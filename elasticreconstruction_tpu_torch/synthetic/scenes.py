"""Procedural test scenes and camera trajectories.

Counterpart of ``elasticreconstruction_tpu/synthetic/scenes.py``: the same
scenes, built from the port's SDF primitives, and the same numpy
trajectories. ``livingroom_scene`` is the stand-in for augmented ICL-NUIM ``livingroom1``
(SURVEY.md §6): a furnished room interior with enough non-planar geometry for
FPFH/ICP to lock onto.  Trajectories are smooth camera-to-world pose
sequences with exact ground truth.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import se3
from . import sdf as S

# World convention: y up, meters.  Camera convention (core.camera): +z
# forward, +y down in the image — poses below are camera-to-world.

ROOM_HALF = (3.0, 1.5, 2.5)  # 6 x 3 x 5 m livingroom
ROOM_CENTER = (0.0, 1.5, 0.0)


def livingroom_scene(*, bare_minus_z: bool = False) -> S.SDF:
    """A furnished room interior (watertight from the inside).

    Wall coverage matters: augmented ICL-NUIM ``livingroom1`` (the scene this
    stands in for — SURVEY.md §6) has furniture, curtains, windows, frames and
    skirting on every wall, so frame-to-model odometry never faces a bare
    plane for hundreds of frames.  Round 2's first cut left two walls blank
    over ~56 deg of the orbit, which is a *harder* scene than the benchmark —
    point-to-plane tracking there is information-theoretically blind to
    in-plane motion (VERDICT r2 #1).  The v2 scene distributes wall-mounted
    relief (door/window frames, pictures, radiator, baseboard) like the real
    room; the deliberately bare-wall degenerate case lives on as a targeted
    regression test (tests/test_degenerate_tracking.py).

    ``bare_minus_z=True`` strips ALL relief (and the skirting) from the −z
    wall, reproducing round 2's degenerate geometry as a production-scale
    ladder variant: an orbiting camera faces a featureless plane for a ~60°
    arc, which must trip the tracking-health detection and exercise the
    suspect-odometry repair path (milestones.py config3_degenerate).
    """
    room = S.invert(S.box(ROOM_CENTER, ROOM_HALF))
    sofa_seat = S.rounded_box((-2.2, 0.35, 0.0), (0.45, 0.3, 1.0), 0.05)
    sofa_back = S.rounded_box((-2.65, 0.8, 0.0), (0.15, 0.5, 1.0), 0.05)
    table = S.box((0.0, 0.45, 0.0), (0.6, 0.05, 0.4))
    table_leg = S.cylinder_y((0.0, 0.2, 0.0), 0.08, 0.2)
    lamp = S.sphere((2.3, 1.0, -1.8), 0.35)
    lamp_pole = S.cylinder_y((2.3, 0.35, -1.8), 0.05, 0.35)
    shelf1 = S.box((0.0, 1.0, 2.3), (1.2, 0.05, 0.18))
    shelf2 = S.box((0.0, 1.6, 2.3), (1.2, 0.05, 0.18))
    books = S.rounded_box((-0.4, 1.2, 2.3), (0.3, 0.14, 0.12), 0.02)
    chair = S.rounded_box((1.8, 0.45, 1.6), (0.3, 0.45, 0.3), 0.08)
    ottoman = S.rounded_box((-0.9, 0.25, -1.6), (0.35, 0.25, 0.35), 0.06)
    wall_art = S.box((2.95, 1.6, 0.5), (0.04, 0.4, 0.6))
    # --- wall relief (v2): every wall carries features a real room has ---
    # -x wall (x = -3): door frame + picture beside the sofa.
    door_frame = S.subtract(
        S.box((-2.97, 1.05, -1.5), (0.06, 1.05, 0.5)),
        S.box((-2.95, 1.0, -1.5), (0.08, 0.95, 0.4)),
    )
    pic_minus_x = S.box((-2.96, 1.7, 1.3), (0.04, 0.35, 0.45))
    # -z wall (z = -2.5): window frame + sill, radiator below, two pictures.
    window_frame = S.subtract(
        S.box((0.2, 1.6, -2.46), (0.8, 0.75, 0.05)),
        S.box((0.2, 1.6, -2.44), (0.7, 0.65, 0.08)),
    )
    window_sill = S.box((0.2, 0.82, -2.42), (0.9, 0.03, 0.09))
    radiator = S.rounded_box((0.2, 0.35, -2.4), (0.7, 0.3, 0.06), 0.03)
    pic_minus_z_a = S.box((-1.7, 1.5, -2.46), (0.35, 0.45, 0.05))
    pic_minus_z_b = S.box((1.9, 1.45, -2.46), (0.3, 0.4, 0.05))
    sideboard = S.rounded_box((-1.8, 0.35, -2.2), (0.5, 0.35, 0.25), 0.03)
    # +x wall (x = 3): tall bookcase + floor plant.
    bookcase = S.box((2.85, 0.9, -0.6), (0.15, 0.9, 0.45))
    plant_pot = S.cylinder_y((2.6, 0.15, 1.6), 0.18, 0.15)
    plant_ball = S.sphere((2.6, 0.75, 1.6), 0.4)
    # +z wall (z = 2.5): cabinet + picture flanking the shelves.
    cabinet = S.box((1.9, 0.5, 2.3), (0.45, 0.5, 0.18))
    pic_plus_z = S.box((-1.9, 1.5, 2.46), (0.4, 0.4, 0.05))
    # Baseboard ring: a 8 cm skirting step along every wall (horizontal edge
    # breaks the vertical in-plane direction everywhere).
    baseboard = S.subtract(
        S.box((0.0, 0.04, 0.0), (3.0, 0.08, 2.5)),
        S.box((0.0, 0.05, 0.0), (2.96, 0.12, 2.46)),
    )
    if bare_minus_z:
        # Strip the −z wall bare: no window/radiator/pictures/sideboard and
        # cut the skirting ring along that wall.
        baseboard = S.subtract(baseboard, S.box((0.0, 0.1, -2.48), (2.9, 0.3, 0.25)))
        minus_z_relief = []
    else:
        minus_z_relief = [
            window_frame,
            window_sill,
            radiator,
            pic_minus_z_a,
            pic_minus_z_b,
            sideboard,
        ]
    return S.union(
        room,
        sofa_seat,
        sofa_back,
        table,
        table_leg,
        lamp,
        lamp_pole,
        shelf1,
        shelf2,
        books,
        chair,
        ottoman,
        wall_art,
        door_frame,
        pic_minus_x,
        *minus_z_relief,
        bookcase,
        plant_pot,
        plant_ball,
        cabinet,
        pic_plus_z,
        baseboard,
    )


def office_scene() -> S.SDF:
    """An office stand-in for augmented ICL-NUIM ``office1``/``office2``
    (SURVEY.md §6): different room aspect (7 x 3 x 4 m), desk/monitor/shelf
    geometry, relief on every wall so an orbiting camera always sees
    trackable structure."""
    half = (3.5, 1.5, 2.0)
    room = S.invert(S.box((0.0, 1.5, 0.0), half))
    # Desk row along the -z wall: two desks with monitors and a chair each.
    desk1 = S.box((-1.6, 0.72, -1.6), (0.8, 0.03, 0.35))
    desk1_legs = S.box((-1.6, 0.36, -1.6), (0.75, 0.36, 0.02))
    mon1 = S.box((-1.6, 1.05, -1.8), (0.3, 0.18, 0.03))
    chair1 = S.rounded_box((-1.6, 0.4, -1.0), (0.25, 0.4, 0.25), 0.06)
    desk2 = S.box((0.6, 0.72, -1.6), (0.8, 0.03, 0.35))
    desk2_legs = S.box((0.6, 0.36, -1.6), (0.75, 0.36, 0.02))
    mon2 = S.box((0.45, 1.05, -1.8), (0.3, 0.18, 0.03))
    chair2 = S.rounded_box((0.6, 0.4, -1.0), (0.25, 0.4, 0.25), 0.06)
    whiteboard = S.box((2.6, 1.5, -1.96), (0.7, 0.45, 0.04))
    poster_a = S.box((0.0, 1.35, -1.96), (0.35, 0.3, 0.05))
    shelf_b = S.box((-1.0, 1.3, -1.9), (0.45, 0.04, 0.14))
    binders = S.rounded_box((-1.1, 1.45, -1.9), (0.2, 0.12, 0.1), 0.02)
    # +z wall: bookshelf bank + filing cabinets + door frame.
    shelf_a = S.box((-2.0, 1.0, 1.82), (0.9, 0.9, 0.18))
    cabinet_a = S.rounded_box((0.2, 0.55, 1.75), (0.35, 0.55, 0.22), 0.02)
    cabinet_b = S.rounded_box((1.1, 0.55, 1.75), (0.35, 0.55, 0.22), 0.02)
    door_frame = S.subtract(
        S.box((2.5, 1.05, 1.95), (0.55, 1.05, 0.06)),
        S.box((2.5, 1.0, 1.93), (0.45, 0.95, 0.1)),
    )
    poster_b = S.box((0.1, 1.4, 1.96), (0.4, 0.3, 0.05))
    shelf_c = S.box((-0.9, 1.35, 1.88), (0.4, 0.04, 0.16))
    box_on_shelf = S.rounded_box((-0.8, 1.5, 1.88), (0.15, 0.11, 0.12), 0.02)
    # -x wall: window frame + radiator + plant.
    window = S.subtract(
        S.box((-3.46, 1.6, 0.2), (0.05, 0.7, 0.9)),
        S.box((-3.44, 1.6, 0.2), (0.08, 0.6, 0.8)),
    )
    radiator = S.rounded_box((-3.4, 0.35, 0.2), (0.06, 0.3, 0.8), 0.03)
    plant_pot = S.cylinder_y((-3.1, 0.15, -1.5), 0.18, 0.15)
    plant_ball = S.sphere((-3.1, 0.7, -1.5), 0.35)
    # +x wall: pinboard + tall locker + wall clock (sphere).
    pinboard = S.box((3.46, 1.5, -0.6), (0.04, 0.45, 0.7))
    locker = S.box((3.3, 0.9, 1.0), (0.2, 0.9, 0.35))
    clock = S.sphere((3.42, 2.1, 0.2), 0.18)
    # Meeting table in the middle.
    table = S.box((1.2, 0.72, 0.6), (0.6, 0.03, 0.45))
    table_leg = S.cylinder_y((1.2, 0.36, 0.6), 0.1, 0.36)
    baseboard = S.subtract(
        S.box((0.0, 0.04, 0.0), (3.5, 0.08, 2.0)),
        S.box((0.0, 0.05, 0.0), (3.46, 0.12, 1.96)),
    )
    return S.union(
        room, desk1, desk1_legs, mon1, chair1, desk2, desk2_legs, mon2, chair2,
        whiteboard, poster_a, shelf_b, binders, shelf_a, cabinet_a, cabinet_b,
        door_frame, poster_b, shelf_c, box_on_shelf, window, radiator,
        plant_pot, plant_ball, pinboard, locker, clock, table, table_leg, baseboard,
    )


def livingroom2_scene() -> S.SDF:
    """A second livingroom variant (stand-in for ``livingroom2``): smaller
    squarer room (5 x 3 x 4.6 m), rearranged furniture, its own wall relief."""
    half = (2.5, 1.5, 2.3)
    room = S.invert(S.box((0.0, 1.5, 0.0), half))
    sofa_seat = S.rounded_box((0.0, 0.35, -1.85), (1.0, 0.3, 0.4), 0.05)
    sofa_back = S.rounded_box((0.0, 0.8, -2.2), (1.0, 0.5, 0.12), 0.05)
    tv_stand = S.box((0.0, 0.3, 2.05), (0.9, 0.3, 0.2))
    tv = S.box((0.0, 1.2, 2.2), (0.7, 0.4, 0.04))
    coffee_table = S.box((0.0, 0.35, -0.6), (0.5, 0.04, 0.35))
    ct_leg = S.cylinder_y((0.0, 0.16, -0.6), 0.07, 0.16)
    armchair = S.rounded_box((-1.7, 0.45, -0.9), (0.35, 0.45, 0.35), 0.08)
    floor_lamp_pole = S.cylinder_y((1.9, 0.6, -1.6), 0.04, 0.6)
    floor_lamp = S.sphere((1.9, 1.45, -1.6), 0.25)
    rug_step = S.box((0.0, 0.015, -0.5), (1.1, 0.015, 0.9))
    # -x wall: bookcase + picture.
    bookcase = S.box((-2.38, 1.0, 0.8), (0.12, 1.0, 0.5))
    pic_minus_x = S.box((-2.46, 1.7, -0.8), (0.04, 0.35, 0.45))
    # +x wall: sideboard + two pictures.
    sideboard = S.rounded_box((2.25, 0.4, 0.6), (0.22, 0.4, 0.55), 0.03)
    pic_plus_x_a = S.box((2.46, 1.6, -0.4), (0.04, 0.4, 0.3))
    pic_plus_x_b = S.box((2.46, 1.5, 1.5), (0.04, 0.3, 0.35))
    # -z wall: window + curtain block beside the sofa.
    window = S.subtract(
        S.box((-1.4, 1.65, -2.26), (0.6, 0.65, 0.05)),
        S.box((-1.4, 1.65, -2.24), (0.5, 0.55, 0.08)),
    )
    curtain = S.rounded_box((1.6, 1.5, -2.2), (0.18, 1.1, 0.1), 0.05)
    # +z wall: shelf pair flanking the TV.
    shelf1 = S.box((-1.6, 1.3, 2.12), (0.5, 0.04, 0.16))
    shelf2 = S.box((1.6, 1.5, 2.12), (0.5, 0.04, 0.16))
    vase = S.cylinder_y((-1.6, 1.45, 2.12), 0.08, 0.12)
    baseboard = S.subtract(
        S.box((0.0, 0.04, 0.0), (2.5, 0.08, 2.3)),
        S.box((0.0, 0.05, 0.0), (2.46, 0.12, 2.26)),
    )
    return S.union(
        room, sofa_seat, sofa_back, tv_stand, tv, coffee_table, ct_leg, armchair,
        floor_lamp_pole, floor_lamp, rug_step, bookcase, pic_minus_x, sideboard,
        pic_plus_x_a, pic_plus_x_b, window, curtain, shelf1, shelf2, vase, baseboard,
    )


def look_at_pose(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world 4x4 with +z forward toward ``target``, image +y down."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, dtype=np.float64)
    x = np.cross(fwd, up)
    if np.linalg.norm(x) < 1e-6:  # looking straight up/down
        x = np.cross(fwd, (1.0, 0.0, 0.0))
    x /= np.linalg.norm(x)
    y = np.cross(fwd, x)
    R = np.stack([x, y, fwd], axis=1)  # columns = camera axes in world
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = eye
    return T


def orbit_trajectory(
    num_frames: int,
    *,
    radius: float = 1.2,
    height: float = 1.3,
    sweep: float = 2.0 * np.pi,
    start_angle: float = 0.0,
    look_radius: float = 10.0,
    bob: float = 0.08,
    center=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """Camera orbits the room center looking outward at the walls.

    Full ``sweep`` = a loop-closing trajectory (the PGO test case); small
    sweeps give the within-fragment odometry motions.  Returns ``(T, 4, 4)``
    float32 camera-to-world poses.
    """
    cx, _, cz = center
    poses = []
    for k in range(num_frames):
        a = start_angle + sweep * k / max(num_frames, 1)
        eye = (
            cx + radius * np.cos(a),
            height + bob * np.sin(3.1 * a),
            cz + radius * np.sin(a),
        )
        target = (cx + look_radius * np.cos(a), height * 0.7, cz + look_radius * np.sin(a))
        poses.append(look_at_pose(eye, target))
    return np.stack(poses).astype(np.float32)


def pendulum_trajectory(
    num_frames: int,
    *,
    radius: float = 1.2,
    height: float = 1.3,
    amplitude: float = 0.8,
    start_angle: float = 0.0,
    look_radius: float = 10.0,
    bob: float = 0.05,
    center=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """There-and-back sweep: revisits its start => loop-closure opportunity
    with bounded per-frame motion (a compressed stand-in for the multi-pass
    ICL-NUIM trajectories)."""
    cx, _, cz = center
    poses = []
    for k in range(num_frames):
        a = start_angle + amplitude * np.sin(np.pi * k / max(num_frames - 1, 1))
        eye = (
            cx + radius * np.cos(a),
            height + bob * np.sin(2.3 * a),
            cz + radius * np.sin(a),
        )
        target = (cx + look_radius * np.cos(a), height * 0.7, cz + look_radius * np.sin(a))
        poses.append(look_at_pose(eye, target))
    return np.stack(poses).astype(np.float32)


def survey_trajectory(
    num_frames: int,
    *,
    radius: float = 1.2,
    height: float = 1.3,
    sweep: float = 2.0 * np.pi,
    start_angle: float = 0.0,
    look_radius: float = 10.0,
    radius_cycles: int = 3,
    radius_depth: float = 0.35,
    pan_cycles: int = 2,
    pan_amplitude: float = 0.35,
    height_bob: float = 0.22,
    center=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """Calibration-style survey orbit: loop-closing like :func:`orbit_trajectory`
    but with in-out radius cycles, look-direction panning and height bob, so
    the same wall regions are observed NEAR and FAR and at CENTER and CORNER
    of the image.  A plain circular orbit views every surface from a single
    range/image-position combination — measured (round 5): that makes a
    depth-distortion field f(u, v, d) barely identifiable from
    correspondence differentials (exact-association GN recovers only ~0.22
    of the learnable field), no matter how good the optimizer.  The CVPR'14
    SLAC input regime is a handheld scan with exactly this kind of range and
    framing diversity (SURVEY.md §0 paper 2).  All modulations are whole
    -cycle over the sweep, so the loop still closes for PGO.
    """
    cx, _, cz = center
    poses = []
    for k in range(num_frames):
        s = k / max(num_frames, 1)
        a = start_angle + sweep * s
        r = radius * (1.0 - radius_depth * 0.5 * (1.0 - np.cos(2 * np.pi * radius_cycles * s)))
        pan = pan_amplitude * np.sin(2 * np.pi * pan_cycles * s)
        eye = (
            cx + r * np.cos(a),
            height + height_bob * np.sin(2 * np.pi * (radius_cycles + 1) * s),
            cz + r * np.sin(a),
        )
        target = (
            cx + look_radius * np.cos(a + pan),
            height * 0.7,
            cz + look_radius * np.sin(a + pan),
        )
        poses.append(look_at_pose(eye, target))
    return np.stack(poses).astype(np.float32)


def perturbed_poses(poses: np.ndarray, trans_sigma: float, rot_sigma: float, seed: int = 0) -> np.ndarray:
    """Gaussian SE(3) noise on a trajectory (for eval/unit tests)."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate(
        [
            rng.normal(0, trans_sigma, size=(len(poses), 3)),
            rng.normal(0, rot_sigma, size=(len(poses), 3)),
        ],
        axis=1,
    ).astype(np.float32)
    noise = se3.exp(torch.from_numpy(xi)).numpy()
    return np.einsum("nij,njk->nik", noise, poses).astype(np.float32)
