"""Host ms of the `registration.odometry_edges` span (the consecutive pairs' batched ICP, both information batches,
the trust region, the readbacks, the `odometry.*` files and the suspect list) of one profiled registration stage,
an odometry edge (the `odometry_edges` counter of the `registration.stage` root)."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("registration.odometry_edges", "registration.stage", "odometry_edges")
