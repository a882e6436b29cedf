"""Odometry Gauss-Newton on the card: CUDA kernel ``csrc/gn_step.cu``.

The plain version is ``odometry/kinfu.py::_gn_level_plain``, which
``odometry/kinfu.py::_gn_level`` runs for CPU tensors; for CUDA tensors it
calls :func:`gn_level_cuda`. The kernel replaces no TPU kernel (the
reference's Gauss-Newton is plain jnp): one launch does a whole step, the
image pass's association, Jacobian and 6x6 sums in every block and the
step's update (two 3x3 eigendecompositions, the prior, the damped solve, the
clip and gate, the pose update) in the last block, in place of about 320
small launches and one ``eigh`` host synchronisation. The pose stays on the
device: each step's launch reads it from the state the previous one wrote.
Only the order of the float32 sums differs from the plain version, so the
two agree to a tolerance (``tests/test_torch_gn_kernel.py``), not bit for
bit; the kernel agrees with itself bit for bit (no float atomics).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core import camera as cam
from ...core.types import f32_reciprocal
from . import build

STATE = 48  # floats of a level's state: T (16, row-major), n_ok, rmse, obs, then the sums
SUMS = 29  # 21 upper-triangle H (row-major), g (6), n_ok, sum r^2
_N_OK, _RMSE, _OBS, _SUMS = 16, 17, 18, 19
_UPPER = [(i, j) for i in range(6) for j in range(i, 6)]


_KERNEL = build.Kernel(
    "gn_step", "gn_step",
    [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_double] * 4 + [ctypes.c_void_p] * 6 + [ctypes.c_float] * 6,
    on_load=lambda lib: build.bind(lib, "er_gn_step_blocks", [ctypes.c_int] * 2),
)


def _launcher(depth: torch.Tensor, intr: cam.Intrinsics, model, model_pose: torch.Tensor,
              model_intr: cam.Intrinsics, T_prior: torch.Tensor, cfg, state: torch.Tensor):
    """Check the level's inputs once and return ``launch(T_in)``: one step from
    the pose ``T_in`` (a (4, 4) tensor, or ``state`` itself) into ``state``."""
    h, w = depth.shape
    mh, mw = model_intr.height, model_intr.width
    build.check_args(
        "gn_step",
        {"depth": depth, "vertices": model.vertices, "normals": model.normals, "valid": model.valid,
         "model_pose": model_pose, "T_prior": T_prior, "state": state},
        {"depth": torch.float32, "vertices": torch.float32, "normals": torch.float32, "valid": torch.bool,
         "model_pose": torch.float32, "T_prior": torch.float32, "state": torch.float32},
        {"depth": (h, w), "vertices": (mh, mw, 3), "normals": (mh, mw, 3), "valid": (mh, mw),
         "model_pose": (4, 4), "T_prior": (4, 4), "state": (STATE,)})
    if (intr.height, intr.width) != (h, w):
        raise ValueError(f"gn_step: intrinsics of {intr.height}x{intr.width} for a depth of {h}x{w}")
    dev = depth.device
    partials = build.scratch(dev, SUMS * _KERNEL.lib.er_gn_step_blocks(h, w))
    counter = build.counters(dev, 1)
    f32 = np.float32
    head = (depth.data_ptr(), h, w, float(f32(intr.cx)), float(f32(intr.cy)), f32_reciprocal(intr.fx),
            f32_reciprocal(intr.fy), model.vertices.data_ptr(), model.normals.data_ptr(), model.valid.data_ptr(),
            mh, mw, float(model_intr.fx), float(model_intr.fy), float(model_intr.cx), float(model_intr.cy),
            model_pose.data_ptr())
    tail = (T_prior.data_ptr(), state.data_ptr(), partials.data_ptr(), counter.data_ptr(),
            float(f32(cfg.dist_threshold**2)), float(f32(cfg.prior_beta)), float(f32(cfg.damping)),
            float(f32(cfg.min_support)), float(f32(cfg.max_step)), f32_reciprocal(6.0),
            torch.cuda.current_stream(dev).cuda_stream)

    def launch(T_in: torch.Tensor) -> None:
        if T_in is not state:
            build.check_args("gn_step", {"depth": depth, "T_in": T_in}, {"depth": torch.float32,
                             "T_in": torch.float32}, {"depth": (h, w), "T_in": (4, 4)})
        _KERNEL.launch(*head, T_in.data_ptr(), *tail)

    return launch


def gn_level_cuda(depth, intr, model, model_pose, model_intr, T0, T_prior, iters: int, cfg):
    """``iters`` steps of :func:`..odometry.kinfu._gn_level` on the card, one
    launch each: ``(pose, n_ok, rmse, obs)`` of the last step, views of the
    level's state tensor (``None`` but the pose when ``iters`` is 0, as the
    plain version returns)."""
    if iters <= 0:
        return T0, None, None, None
    state = torch.empty(STATE, dtype=torch.float32, device=depth.device)
    launch = _launcher(depth, intr, model, model_pose.contiguous(), model_intr, T_prior.contiguous(), cfg, state)
    launch(T0.contiguous())
    for _ in range(iters - 1):
        launch(state)
    return state[:16].view(4, 4), state[_N_OK], state[_RMSE], state[_OBS]


def gn_step_cuda(depth, intr, model, model_pose, model_intr, T, T_prior, cfg) -> torch.Tensor:
    """One step from the pose ``T``: the new state tensor (read it with :func:`unpack`)."""
    state = torch.empty(STATE, dtype=torch.float32, device=depth.device)
    _launcher(depth, intr, model, model_pose.contiguous(), model_intr, T_prior.contiguous(), cfg,
              state)(T.contiguous())
    return state


def unpack(state: torch.Tensor) -> dict:
    """A state tensor's fields, copied to the host: the pose the step wrote,
    its n_ok, rmse and obs, and the data term's sums at the pose it started
    from (H (6, 6), g (6,), the support and sum r^2)."""
    s = state.detach().cpu()
    sums = s[_SUMS:]
    H = torch.empty((6, 6), dtype=s.dtype)
    for k, (i, j) in enumerate(_UPPER):
        H[i, j] = H[j, i] = sums[k]
    return {"pose": s[:16].view(4, 4), "n_ok": s[_N_OK], "rmse": s[_RMSE], "obs": s[_OBS], "H": H,
            "g": sums[21:27], "support": sums[27], "sum_r2": sums[28]}
