"""The per-pair registration stage: FPFH -> RANSAC -> ICP -> information matrix.

Counterpart of ``elasticreconstruction_tpu/registration/pair.py`` (the
reference's GlobalRegistration body). Fragments are prepped once (voxel
downsample, radius normals, FPFH at the coarse scale; downsample and normals
at the fine scale), then pair batches are registered on the prepped arrays.

Convention: the returned ``transform`` maps fragment-j points into fragment
i's frame (``T @ p_j ~= p_i``), the reference's .log record for edge (i, j).

Entry points that take host data or build tensors take ``device=`` (default
``"cuda"``, which raises if no card is present); the others run on the
device of the tensors they are given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3, trace
from ..core.types import PointCloud, RegistrationResult, resolve_device
from ..kernels import fpfh as _fpfh
from ..kernels import knn as _knn
from ..kernels import normals as _normals
from ..kernels import voxel_grid as _voxel
from . import features as _features
from . import icp as _icp
from . import infomat as _infomat
from . import ransac as _ransac


class RegistrationConfig(NamedTuple):
    """Stage constants: the same fields and defaults as the JAX package's."""

    voxel_size: float = 0.05  # coarse voxel for features/RANSAC
    icp_voxel_size: float = 0.025  # fine voxel for ICP refinement
    coarse_capacity: int = 4096
    fine_capacity: int = 8192
    normal_radius_factor: float = 2.0  # normals radius = factor * voxel
    fpfh_radius_factor: float = 5.0  # FPFH radius = factor * voxel
    inlier_threshold: float = 0.075
    edge_similarity: float = 0.9
    num_hypotheses: int = 4096
    icp_iterations: int = 30
    # ICP matches every icp_src_stride-th source point (the downsample output is
    # in hash-scrambled voxel order, so this is a spatially uniform subset); the
    # dst stays dense, since it sets the correspondence accuracy.
    icp_src_stride: int = 2
    # The first icp_coarse_iterations run on every icp_coarse_stride-th
    # (already strided) source point.
    icp_coarse_iterations: int = 12
    icp_coarse_stride: int = 4
    min_inliers: int = 12
    min_fitness: float = 0.25  # min fraction of src points matched after ICP


class PreppedFragments(NamedTuple):
    """Per-fragment registration inputs, computed ONCE per fragment."""

    coarse: PointCloud  # (F, Nc, ...) downsampled + normals
    features: torch.Tensor  # (F, Nc, 33) FPFH
    fine: PointCloud  # (F, Nf, ...) ICP-resolution cloud + normals

    def take(self, index) -> "PreppedFragments":
        return PreppedFragments(self.coarse.take(index), self.features[index], self.fine.take(index))


def _as_cloud(clouds, dev: torch.device) -> PointCloud:
    return PointCloud(
        torch.as_tensor(clouds.points, dtype=torch.float32, device=dev),
        torch.as_tensor(clouds.normals, dtype=torch.float32, device=dev),
        torch.as_tensor(clouds.mask, dtype=torch.bool, device=dev),
    )


def _stack(clouds: list[PointCloud]) -> PointCloud:
    return PointCloud(*(torch.stack(xs) for xs in zip(*clouds)))


def _prep_coarse(cloud: PointCloud, cfg: RegistrationConfig):
    with trace.span("registration.voxel"):
        ds = _voxel.voxel_downsample(cloud, cfg.voxel_size, cfg.coarse_capacity)
    with trace.span("registration.normals"):
        ds = _normals.estimate_normals_radius(ds, cfg.voxel_size * cfg.normal_radius_factor)
    with trace.span("registration.fpfh"):
        return ds, _fpfh.fpfh_radius(ds, cfg.voxel_size * cfg.fpfh_radius_factor)


def _fine(cloud: PointCloud, cfg: RegistrationConfig, with_normals: bool = True) -> PointCloud:
    with trace.span("registration.voxel"):
        ds = _voxel.voxel_downsample(cloud, cfg.icp_voxel_size, cfg.fine_capacity)
    if not with_normals:
        return ds
    with trace.span("registration.normals"):
        return _normals.estimate_normals_radius(ds, cfg.icp_voxel_size * cfg.normal_radius_factor)


def prep_fragments_batch(
    clouds: PointCloud, config: RegistrationConfig = RegistrationConfig(), *, device="cuda"
) -> PreppedFragments:
    """Run the per-fragment pipeline (downsample/normals/FPFH, both scales).

    ``clouds`` holds ``(F, N, ...)`` arrays (numpy or tensors).
    """
    with trace.span("registration.prep"):
        clouds = _as_cloud(clouds, resolve_device(device))
        trace.count("fragments", clouds.points.shape[0])
        coarse, feats, fine = [], [], []
        for f in range(clouds.points.shape[0]):
            cloud = clouds.take(f)
            ds, feat = _prep_coarse(cloud, config)
            coarse.append(ds)
            feats.append(feat)
            fine.append(_fine(cloud, config))
        return PreppedFragments(coarse=_stack(coarse), features=torch.stack(feats), fine=_stack(fine))


def _indices(ix, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(ix, device=dev).to(torch.int64)


def register_prepped_batch(
    prepped: PreppedFragments,
    idx_i,
    idx_j,
    generator: torch.Generator | None = None,
    config: RegistrationConfig = RegistrationConfig(),
    *,
    draws: torch.Tensor | None = None,
    fused_step: bool = False,
    device="cuda",
) -> RegistrationResult:
    """Register pairs ``(idx_i[k], idx_j[k])`` of already-prepped fragments.

    The production all-pairs path: matching -> RANSAC -> batched ICP -> info
    matrix. RANSAC hypotheses come from ``draws`` ``(B, H, 3)`` if given, else
    from ``generator``.
    """
    dev = resolve_device(device)
    prepped = PreppedFragments(prepped.coarse.to(dev), prepped.features.to(dev), prepped.fine.to(dev))
    ii, jj = _indices(idx_i, dev), _indices(idx_j, dev)
    pi, pj = prepped.take(ii), prepped.take(jj)
    return _register_core(
        pi.coarse, pi.features, pj.coarse, pj.features, pi.fine, pj.fine,
        config, (ii.to(torch.int32), jj.to(torch.int32)), generator, draws, fused_step,
    )


def register_pairs_batch(
    clouds_i: PointCloud,
    clouds_j: PointCloud,
    generator: torch.Generator | None = None,
    config: RegistrationConfig = RegistrationConfig(),
    pair_indices=None,
    *,
    draws: torch.Tensor | None = None,
    fused_step: bool = False,
    device="cuda",
) -> RegistrationResult:
    """Register a whole ``(B, N, 3)`` batch of fragment pairs, prepping both sides inline.

    Use :func:`prep_fragments_batch` + :func:`register_prepped_batch` when
    fragments recur across pairs. As in the reference, the j-side fine cloud
    is only downsampled: ICP needs normals on the dst side alone.
    """
    dev = resolve_device(device)
    clouds_i, clouds_j = _as_cloud(clouds_i, dev), _as_cloud(clouds_j, dev)
    b = clouds_i.points.shape[0]
    if pair_indices is None:
        pair_indices = (torch.zeros(b, dtype=torch.int32), torch.ones(b, dtype=torch.int32))
    pair_indices = tuple(torch.as_tensor(x, device=dev).to(torch.int32) for x in pair_indices)
    with trace.span("registration.prep"):
        trace.count("fragments", 2 * b)
        side_i = [_prep_coarse(clouds_i.take(k), config) for k in range(b)]
        side_j = [_prep_coarse(clouds_j.take(k), config) for k in range(b)]
        fine_i = _stack([_fine(clouds_i.take(k), config) for k in range(b)])
        fine_j = _stack([_fine(clouds_j.take(k), config, with_normals=False) for k in range(b)])
    return _register_core(
        _stack([d for d, _ in side_i]), torch.stack([f for _, f in side_i]),
        _stack([d for d, _ in side_j]), torch.stack([f for _, f in side_j]),
        fine_i, fine_j, config, pair_indices, generator, draws, fused_step,
    )


def _register_core(ds_i, feat_i, ds_j, feat_j, fine_i, fine_j, cfg, pair_indices,
                   generator, draws, fused_step) -> RegistrationResult:
    """Matching -> RANSAC -> batched ICP -> info matrix on prepped ``(B, ...)`` inputs."""
    with trace.span("registration.batch"):
        trace.count("pairs", ds_i.points.shape[0])
        with trace.span("registration.match"):
            corr, corr_mask = _features.match_features(feat_j, ds_j.mask, feat_i, ds_i.mask)
        with trace.span("registration.ransac"):
            rr = _ransac.ransac_alignment(
                ds_j.points, ds_i.points, corr, corr_mask, generator,
                draws=draws,
                inlier_threshold=cfg.inlier_threshold,
                edge_similarity=cfg.edge_similarity,
                num_hypotheses=cfg.num_hypotheses,
            )
        icp_src = (
            PointCloud(*(x[:, :: cfg.icp_src_stride] for x in fine_j))
            if cfg.icp_src_stride > 1
            else fine_j
        )
        with trace.span("registration.icp"):
            ir = _icp.icp_point_to_plane_batch(
                icp_src,
                fine_i,
                rr.transform,
                max_correspondence_distance=cfg.inlier_threshold,
                iterations=cfg.icp_iterations,
                coarse_iterations=cfg.icp_coarse_iterations,
                coarse_stride=cfg.icp_coarse_stride,
                # RANSAC-failed lanes can never pass the success test below: they
                # must not hold the batch's ICP early exit.
                dead=rr.num_inliers < cfg.min_inliers,
                fused_step=fused_step,
            )
        # Information matrix over src points in the target (i) frame, restricted
        # to points with a close match under the final transform.
        with trace.span("registration.infomat"):
            info = _information(ir.transform, fine_i, fine_j, cfg.inlier_threshold)
        success = (
            (rr.num_inliers >= cfg.min_inliers)
            & (ir.fitness >= cfg.min_fitness)
            & torch.isfinite(ir.transform).all(-1).all(-1)
        )
        return RegistrationResult(
            i=pair_indices[0],
            j=pair_indices[1],
            transform=ir.transform,
            information=info,
            num_inliers=rr.num_inliers,
            fitness=ir.fitness,
            success=success,
        )


def _information(T, fine_i: PointCloud, fine_j: PointCloud, threshold: float) -> torch.Tensor:
    p = se3.apply(T, fine_j.points)
    d2, _ = _knn.nearest_auto_batch(p, fine_i.points, fine_i.mask)
    return _infomat.information_matrix(p, fine_j.mask & (d2 < threshold * threshold))


def register_pair(
    cloud_i: PointCloud,
    cloud_j: PointCloud,
    generator: torch.Generator | None = None,
    config: RegistrationConfig = RegistrationConfig(),
    pair_indices=None,
    *,
    draws: torch.Tensor | None = None,
    fused_step: bool = False,
    device="cuda",
) -> RegistrationResult:
    """Register fragment j onto fragment i (batch-1 wrapper, same contract).

    ``draws``, if given, is ``(H, 3)``.
    """
    if pair_indices is None:
        pair_indices = (0, 1)
    res = register_pairs_batch(
        PointCloud(*(torch.as_tensor(x)[None] for x in cloud_i)),
        PointCloud(*(torch.as_tensor(x)[None] for x in cloud_j)),
        generator,
        config,
        ([pair_indices[0]], [pair_indices[1]]),
        draws=None if draws is None else torch.as_tensor(draws)[None],
        fused_step=fused_step,
        device=device,
    )
    return RegistrationResult(*(x[0] for x in res))


def refine_edges_batch(
    prepped: PreppedFragments,
    idx_i,
    idx_j,
    init_T: torch.Tensor,
    config: RegistrationConfig = RegistrationConfig(),
    *,
    fused_step: bool = False,
) -> tuple[_icp.ICPResult, torch.Tensor]:
    """Refine trusted-init edges (the odometry chain) in ONE batched ICP.

    Runs on the device of ``prepped``. Returns the batched ICP result plus
    per-edge 6x6 information matrices at the refined transforms.
    """
    dev = prepped.features.device
    ii, jj = _indices(idx_i, dev), _indices(idx_j, dev)
    res = _icp.icp_point_to_plane_batch(
        prepped.fine.take(jj),
        prepped.fine.take(ii),
        init_T.to(dev),
        max_correspondence_distance=config.inlier_threshold * 2,
        iterations=config.icp_iterations,
        coarse_iterations=config.icp_coarse_iterations,
        coarse_stride=config.icp_coarse_stride,
        fused_step=fused_step,
    )
    return res, edge_information_batch(prepped, ii, jj, res.transform, config)


def edge_information_batch(
    prepped: PreppedFragments,
    idx_i,
    idx_j,
    T: torch.Tensor,
    config: RegistrationConfig = RegistrationConfig(),
) -> torch.Tensor:
    """Batched ``(E, 6, 6)`` information matrices at given edge transforms."""
    dev = prepped.features.device
    ii, jj = _indices(idx_i, dev), _indices(idx_j, dev)
    return _information(
        T.to(dev), prepped.fine.take(ii), prepped.fine.take(jj), config.inlier_threshold * 2
    )
