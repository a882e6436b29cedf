"""Pipeline orchestration and the file-format contracts.

The reference is five executables run in order, communicating through files;
the file artifacts double as checkpoints: any stage can be re-run from the
previous stage's outputs. This package keeps that property (same
.log/.info/.pcd artifact layout, same resumability).

CLI: ``python -m elasticreconstruction_tpu_torch.pipeline.run <stage> ...``
Stages: synth | fragments | register | posegraph | optimize | integrate | evaluate | all.
"""

from . import config, dataset, stages
from .config import PipelineConfig

__all__ = ["config", "dataset", "stages", "PipelineConfig"]
