"""The odometry Gauss-Newton step's CUDA kernel against its plain version, and the routing between them.

On the card (tests marked ``card``, which skip without one): ``_gn_level`` on
CUDA tensors launches ``kernels/cuda/csrc/gn_step.cu`` once a step, and
each step agrees with the plain step (``kinfu.gn_normal_equations`` and
``kinfu._gn_level_plain``) started from the same pose, on

- a 512^3 volume of 7.8125 mm voxels placed as ``build_fragment`` places it,
  fused from four frames of the livingroom orbit, the fifth frame tracked at
  640x480 on all three levels from a seed moved off its pose: at the default
  configuration, with ``prior_beta = 0`` and with a ``raycast_scale = 2``
  model;
- a frame facing the bare -z wall (``livingroom_scene(bare_minus_z=True)``),
  where a translation direction is unobservable: ``obs_ratio`` and each
  health flag agree;
- a frame with no depth: the pose does not move;
- a model whose invalid pixels carry NaN normals: the sums stay finite.

Every kernel call is made twice and must give the same bits. Tolerances
(float32 sums of up to 307 200 terms taken in another order: the plain
version's matrix product and reductions against the kernel's per-thread,
warp and block sums; a pixel whose projection lies within an ulp of a
rounding boundary, or whose distance lies within an ulp of the threshold,
may be associated by one version and not the other):

- ``H`` within ``H_RTOL`` of its largest entry; ``g`` within ``G_RTOL`` of
  ``sqrt(max|H| * sum r^2)``, the scale that bounds every entry of g;
- the support within ``SUPPORT_RTOL`` of itself, ``sum r^2`` within
  ``R2_RTOL``;
- the pose one step writes, from the same pose, within ``STEP_POSE_ATOL``
  (element-wise; entries of magnitude about 1 to 2 m and a float32 ulp of
  1.2e-7 to 2.4e-7); the pose after a level, each version iterating from the
  level's start, within ``LEVEL_POSE_ATOL``: the two versions' small
  differences feed the next step's association, and the benchmark's judge
  holds whole calls to 3e-5 m of the plain reference.

Run them there without the JAX conftest:
``python -m pytest tests/test_torch_gn_kernel.py --noconftest -p no:cacheprovider -m card -s``.

On the CPU: ``_gn_level`` runs the plain version and never builds a kernel.
"""

import math

import numpy as np
import pytest
import torch

from elasticreconstruction_tpu_torch.core import camera as cam
from elasticreconstruction_tpu_torch.core import se3
from elasticreconstruction_tpu_torch.kernels import raycast as rc
from elasticreconstruction_tpu_torch.kernels import tsdf
from elasticreconstruction_tpu_torch.kernels.cuda import build
from elasticreconstruction_tpu_torch.kernels.cuda import gn_step
from elasticreconstruction_tpu_torch.odometry import kinfu
from elasticreconstruction_tpu_torch.odometry.fragments import FragmentConfig, _volume_origin
from elasticreconstruction_tpu_torch.synthetic import render, scenes

FULL = FragmentConfig(volume_shape=(512, 512, 512), voxel_size=0.0078125, volume_min_z=0.3)
ODOM = kinfu.OdometryConfig(raycast_steps=295)  # the benchmark configuration's tracker
FUSE_KW = dict(max_weight=64.0, depth_min=0.1, depth_max=6.0)
SMALL_INTR = cam.Intrinsics(fx=100.0, fy=100.0, cx=59.5, cy=44.5, width=120, height=90)
NO_CARD = ("needs a CUDA card: run on the card with python -m pytest "
           "tests/test_torch_gn_kernel.py --noconftest -m card")
H_RTOL = 2e-5
G_RTOL = 2e-5
SUPPORT_RTOL = 1e-4
R2_RTOL = 1e-4
STEP_POSE_ATOL = 2e-6
LEVEL_POSE_ATOL = 1e-5
SEED_MOVE = torch.tensor([0.01, -0.006, 0.008, 0.004, -0.005, 0.003])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    return torch.device("cuda")


def _orbit(n: int, intr, dev, scene=None, start: float = 0.7):
    """``n`` consecutive frames of the livingroom orbit (2 pi over 2550 frames):
    depths and camera-to-fragment poses (frame 0 at the identity)."""
    world = scenes.orbit_trajectory(n, radius=1.1, height=1.3, sweep=2 * math.pi * n / 2550, start_angle=start)
    depths = render.render_sequence(scene or scenes.livingroom_scene(), torch.from_numpy(world).to(dev), intr)
    local = np.linalg.inv(world[0].astype(np.float64)) @ world.astype(np.float64)
    return depths, torch.from_numpy(local.astype(np.float32)).to(dev)


def _scene(cfg: FragmentConfig, intr, dev, **orbit_kw):
    """A volume fused from four orbit frames, and the fifth frame with its pose."""
    depths, poses = _orbit(5, intr, dev, **orbit_kw)
    vol = tsdf.make_volume(cfg.volume_shape, cfg.voxel_size, _volume_origin(cfg), device=dev)
    for d, T in zip(depths[:4], poses[:4]):
        vol = tsdf.fuse(vol, d, T, intr, **FUSE_KW)
    return vol, depths[4], poses[4]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _twice(fn):
    """``fn()`` twice on the same inputs: the same bits both times."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(_bits(a), _bits(b)), "two kernel calls on the same inputs differ"
    return first


def _pyramid(depth, intr, levels):
    depths, intrs = [depth], [intr]
    for _ in range(levels - 1):
        depths.append(kinfu.pyramid_down(depths[-1]))
        intrs.append(intrs[-1].scaled(0.5))
    return depths, intrs


def _model(vol, pose, intr, cfg):
    m_intr = intr.scaled(1.0 / cfg.raycast_scale) if cfg.raycast_scale > 1 else intr
    model = rc.raycast(vol, pose, m_intr, depth_min=cfg.depth_min, depth_max=cfg.depth_max,
                       num_steps=cfg.raycast_steps)
    return model, m_intr


def _check_step(depth, intr, model, seed, m_intr, T, cfg, errors: dict) -> torch.Tensor:
    """One kernel step from ``T`` against the plain step from ``T``; returns the kernel's new pose."""
    st = _twice(lambda: (gn_step.gn_step_cuda(depth, intr, model, seed, m_intr, T, seed, cfg),))[0]
    got = gn_step.unpack(st)
    verts = cam.unproject(depth, intr).reshape(-1, 3)
    H, g, wf, r = kinfu.gn_normal_equations(verts, (depth > 0).reshape(-1), model, seed, m_intr, T, cfg)
    H, g = H.cpu().double(), g.cpu().double()
    support, r2 = wf.sum().item(), (wf * r * r).sum().item()
    T_plain = kinfu._gn_level_plain(depth, intr, model, seed, m_intr, T, seed, 1, cfg)[0].cpu()
    h_scale = max(H.abs().max().item(), 1e-30)
    err = {"H": (got["H"].double() - H).abs().max().item() / h_scale,
           "g": (got["g"].double() - g).abs().max().item() / max(math.sqrt(h_scale * r2), 1e-30),
           "support": abs(got["support"].item() - support) / max(support, 1.0),
           "sum_r2": abs(got["sum_r2"].item() - r2) / max(r2, 1e-30),
           "step_pose": (got["pose"] - T_plain).abs().max().item()}
    for k, v in err.items():
        errors[k] = max(errors.get(k, 0.0), v)
    assert got["n_ok"].item() == got["support"].item()
    assert err["H"] <= H_RTOL and err["g"] <= G_RTOL, err
    assert err["support"] <= SUPPORT_RTOL and err["sum_r2"] <= R2_RTOL, err
    assert err["step_pose"] <= STEP_POSE_ATOL, err
    return got["pose"].to(T.device)


@pytest.fixture(scope="module")
def livingroom_512():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    return _scene(FULL, cam.PRIMESENSE, torch.device("cuda"))


@pytest.mark.card
@pytest.mark.parametrize("case", ["default", "prior_beta_0", "raycast_scale_2"])
def test_steps_against_the_plain_step_on_a_512_volume(card, livingroom_512, case):
    vol, depth, pose = livingroom_512
    cfg = {"default": ODOM, "prior_beta_0": ODOM._replace(prior_beta=0.0),
           "raycast_scale_2": ODOM._replace(raycast_scale=2)}[case]
    seed = se3.exp(SEED_MOVE.to(card)) @ pose
    model, m_intr = _model(vol, seed, cam.PRIMESENSE, cfg)
    depths, intrs = _pyramid(depth, cam.PRIMESENSE, cfg.levels)
    errors = {}
    T = seed
    for lvl in range(cfg.levels - 1, -1, -1):
        iters = cfg.iterations[lvl]
        before = build.launches["gn_step"]
        got = _twice(lambda: kinfu._gn_level(depths[lvl], intrs[lvl], model, seed, m_intr, T, seed, iters, cfg))
        assert build.launches["gn_step"] == before + 2 * iters
        want = kinfu._gn_level_plain(depths[lvl], intrs[lvl], model, seed, m_intr, T, seed, iters, cfg)
        level_err = (got[0] - want[0]).abs().max().item()
        errors[f"level_{lvl}_pose"] = level_err
        assert level_err <= LEVEL_POSE_ATOL, (lvl, level_err)
        for _ in range(iters):
            T = _check_step(depths[lvl], intrs[lvl], model, seed, m_intr, T, cfg, errors)
    print(f"\n{case}: largest errors {errors}")
    # Tracked to the frame's pose: the seed was 1.4 cm and 0.4 degrees off it.
    assert (T - pose).abs().max().item() < 2e-3


@pytest.mark.card
def test_track_frame_launches_once_a_step_and_never_synchronises(card, livingroom_512, monkeypatch):
    vol, depth, pose = livingroom_512
    seed = se3.exp(SEED_MOVE.to(card)) @ pose
    kinfu.track_frame(vol, depth, seed, cam.PRIMESENSE, ODOM)  # warm: the libraries' handles
    torch.cuda.synchronize()
    before = build.launches["gn_step"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kinfu.track_frame(vol, depth, seed, cam.PRIMESENSE, ODOM)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert build.launches["gn_step"] == before + sum(ODOM.iterations[:ODOM.levels]) == before + 19
    again = kinfu.track_frame(vol, depth, seed, cam.PRIMESENSE, ODOM)
    for a, b in zip(got, again):
        assert torch.equal(_bits(a), _bits(b))
    monkeypatch.setattr(kinfu, "_gn_level", kinfu._gn_level_plain)
    want = kinfu.track_frame(vol, depth, seed, cam.PRIMESENSE, ODOM)
    assert (got.pose - want.pose).abs().max().item() <= LEVEL_POSE_ATOL
    assert abs(got.fitness.item() - want.fitness.item()) <= SUPPORT_RTOL
    assert abs(got.rmse.item() - want.rmse.item()) <= R2_RTOL * want.rmse.item()


@pytest.mark.card
def test_bare_wall_observability_and_health_agree(card, monkeypatch):
    # The camera faces the bare -z wall: the wall and the floor leave the
    # translation along the wall unobservable, and obs_ratio falls below the
    # health gate.
    vol, depth, pose = _scene(FULL, cam.PRIMESENSE, card, scene=scenes.livingroom_scene(bare_minus_z=True),
                              start=-math.pi / 2)
    seed = se3.exp(SEED_MOVE.to(card)) @ pose
    got = _twice(lambda: kinfu.track_frame(vol, depth, seed, cam.PRIMESENSE, ODOM))
    monkeypatch.setattr(kinfu, "_gn_level", kinfu._gn_level_plain)
    plain = kinfu.track_frame(vol, depth, seed, cam.PRIMESENSE, ODOM)
    print(f"\nbare wall: obs_ratio kernel {got.obs_ratio.item():.6g}, plain {plain.obs_ratio.item():.6g}; "
          f"fitness {got.fitness.item():.6g} / {plain.fitness.item():.6g}")
    assert got.obs_ratio.item() < ODOM.healthy_obs_ratio
    # An unobservable direction's eigenvalue is float32 noise against the
    # largest: the two ratios agree to 1e-4, fifty times under the gate.
    assert abs(got.obs_ratio.item() - plain.obs_ratio.item()) <= 1e-4
    for name, flag in _health_flags(ODOM).items():
        assert flag(got) == flag(plain), name


def _health_flags(cfg) -> dict:
    """``build_fragment``'s per-frame decisions."""
    return {"lost": lambda tr: bool(tr.fitness < 1e-3),
            "observable": lambda tr: bool(tr.obs_ratio > cfg.healthy_obs_ratio),
            "fit": lambda tr: bool(tr.fitness > cfg.healthy_fitness)}


@pytest.mark.card
def test_no_support_freezes_the_pose(card, livingroom_512):
    vol, depth, pose = livingroom_512
    seed = se3.exp(SEED_MOVE.to(card)) @ pose
    model, m_intr = _model(vol, seed, cam.PRIMESENSE, ODOM)
    for empty in (torch.zeros_like(depth), torch.full_like(depth, 50.0)):  # no depth; all beyond the model
        T, n_ok, rmse, obs = _twice(lambda: kinfu._gn_level(empty, cam.PRIMESENSE, model, seed, m_intr, seed,
                                                            seed, 4, ODOM))
        assert torch.equal(_bits(T), _bits(seed))
        assert n_ok.item() == 0.0 and rmse.item() == 0.0


@pytest.mark.card
def test_nan_normals_of_invalid_model_pixels_stay_out_of_the_sums(card, livingroom_512):
    vol, depth, pose = livingroom_512
    seed = se3.exp(SEED_MOVE.to(card)) @ pose
    model, m_intr = _model(vol, seed, cam.PRIMESENSE, ODOM)
    assert (~model.valid).any()
    poisoned = model._replace(normals=torch.where(model.valid[..., None], model.normals, float("nan")),
                              vertices=torch.where(model.valid[..., None], model.vertices, float("nan")))
    clean = gn_step.gn_step_cuda(depth, cam.PRIMESENSE, model, seed, m_intr, seed, seed, ODOM)
    dirty = _twice(lambda: (gn_step.gn_step_cuda(depth, cam.PRIMESENSE, poisoned, seed, m_intr, seed, seed,
                                                 ODOM),))[0]
    assert torch.isfinite(dirty).all()
    assert torch.equal(_bits(clean), _bits(dirty))


def test_cpu_runs_the_plain_version_and_builds_nothing(monkeypatch):
    def refuse(*names):
        raise AssertionError(f"build.load{names} called for CPU tensors")

    monkeypatch.setattr(build, "load", refuse)
    cfg = FragmentConfig(volume_shape=(48, 48, 48), voxel_size=0.05, volume_min_z=0.3)
    odom = kinfu.OdometryConfig(raycast_steps=96)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        vol, depth, pose = _scene(cfg, SMALL_INTR, torch.device("cpu"))
        seed = se3.exp(SEED_MOVE) @ pose
        model, m_intr = _model(vol, seed, SMALL_INTR, odom)
        before = build.launches["gn_step"]
        got = kinfu._gn_level(depth, SMALL_INTR, model, seed, m_intr, seed, seed, 3, odom)
        want = kinfu._gn_level_plain(depth, SMALL_INTR, model, seed, m_intr, seed, seed, 3, odom)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert got[1].item() > 100  # the frame has support
        tr = kinfu.track_frame(vol, depth, seed, SMALL_INTR, odom)
        assert torch.isfinite(tr.pose).all()
        assert build.launches["gn_step"] == before
    finally:
        torch.set_num_threads(threads)
