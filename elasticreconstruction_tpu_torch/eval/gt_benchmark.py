"""Ground-truth fragment-pair benchmark generation (gt.log / gt.info).

Counterpart of ``elasticreconstruction_tpu/eval/gt_benchmark.py``. The
augmented ICL-NUIM registration benchmark lists every non-adjacent fragment
pair with enough surface overlap, its ground-truth relative transform and the
information matrix accumulated over the overlapping points. Here they are
derived from the ground-truth trajectory and the reconstructed fragment
clouds, through the same mutual-nearest harvest as the optimizer's
(``elastic/correspondence.py``).

Convention as ``registration/pair.py``: edge (i, j) stores T with
``T @ p_j ~= p_i`` = inv(P_i_gt) @ P_j_gt.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..core import io_logfmt
from ..core.types import PointCloud
from ..elastic.correspondence import correspondences_for_edge
from ..registration.infomat import information_matrix


def gt_fragment_poses(gt_frame_poses: np.ndarray, frames_per_fragment: int, num_fragments: int) -> np.ndarray:
    """Ground-truth world pose of each fragment's local frame (= frame f*K)."""
    K = frames_per_fragment
    return np.stack([gt_frame_poses[f * K] for f in range(num_fragments)])


def make_gt_edges(
    clouds: list[PointCloud],
    gt_frag_poses: np.ndarray,
    *,
    max_distance: float = 0.075,
    min_overlap: float = 0.3,
    capacity: int = 8192,
    nonconsecutive_only: bool = True,
) -> tuple[list[tuple[int, int, np.ndarray]], dict[tuple[int, int], np.ndarray]]:
    """Enumerate overlapping fragment pairs under the ground-truth poses.

    A pair enters the benchmark when the fraction of fragment j's points with
    a mutual nearest neighbour in fragment i within ``max_distance`` exceeds
    ``min_overlap``. ``clouds`` lie on one device. Returns
    (edges [(i, j, T_gt 4x4)], infos {(i, j): 6x6}).
    """
    nf = len(clouds)
    dev = clouds[0].points.device if nf else torch.device("cpu")
    poses = torch.as_tensor(gt_frag_poses.astype(np.float32), device=dev)
    valid = [int(c.mask.sum()) for c in clouds]
    edges: list[tuple[int, int, np.ndarray]] = []
    infos: dict[tuple[int, int], np.ndarray] = {}
    for i in range(nf):
        start_j = i + 2 if nonconsecutive_only else i + 1
        for j in range(start_j, nf):
            if min(valid[i], valid[j]) == 0:
                continue
            p, _, _, m = correspondences_for_edge(
                clouds[i], clouds[j], poses[i], poses[j], max_distance=max_distance, capacity=capacity
            )
            count = int(m.sum())
            if count / min(valid[j], capacity) < min_overlap:
                continue
            T = np.linalg.inv(gt_frag_poses[i].astype(np.float64)) @ gt_frag_poses[j].astype(np.float64)
            edges.append((i, j, T))
            infos[(i, j)] = information_matrix(p, m).cpu().numpy().astype(np.float64)
    return edges, infos


def write_gt_benchmark(
    out_dir: str | Path,
    edges: list[tuple[int, int, np.ndarray]],
    infos: dict[tuple[int, int], np.ndarray],
    num_fragments: int,
) -> None:
    """Spill gt edges to the reference gt.log/gt.info file formats."""
    out_dir = Path(out_dir)
    io_logfmt.write_log(
        out_dir / "gt.log",
        io_logfmt.Trajectory([io_logfmt.TrajectoryEntry(i, j, num_fragments, T) for i, j, T in edges]),
    )
    io_logfmt.write_info(
        out_dir / "gt.info",
        io_logfmt.InfoFile([io_logfmt.InfoEntry(i, j, num_fragments, infos[(i, j)]) for i, j, _ in edges]),
    )


def read_gt_benchmark(out_dir: str | Path):
    """Load gt.log/gt.info back into the precision_recall input structures."""
    out_dir = Path(out_dir)
    log = io_logfmt.read_log(out_dir / "gt.log")
    info = io_logfmt.read_info(out_dir / "gt.info")
    edges = [(e.i, e.j, e.transform) for e in log.entries]
    infos = {(e.i, e.j): e.info for e in info.entries}
    return edges, infos
