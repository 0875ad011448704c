"""Multi-rank solves over torch.distributed (counterpart of
``thallo_tpu/parallel``): the same names, with ``step_collectives`` in
the place of ``compiled_step_hlo``."""
from .mesh import (  # noqa: F401
    collective_stats,
    distribution_report,
    make_mesh,
    shard_bsr_tables,
    shard_plan_inputs,
    sort_edges_by_owner,
    step_collectives,
)
