"""sqlp_tpu — a two-stage regularized Stochastic Decomposition solver in JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference Julia
implementation yhz0/SQLP (module ``TwoSD``): SMPS problems compile to dense
blocked tensors; the SD inner loop (scenario sampling, batched second-stage
recourse LP solves, argmax cut generation over a growing dual-vertex pool,
multi-epigraph weighted cut pools with lower-bound blending, incumbent cut
refresh, incumbent selection, proximally regularized master QP) runs entirely
on device as one jitted step; scenario batches and dual pools shard over a
``jax.sharding.Mesh``.

Layer map (mirrors reference layers, see SURVEY.md §1):
  models/    problem model: SMPS parsers, stage templates, scenario model,
             instance compilation to device tensors, extensive form (crash)
  ops/       numerical kernels: batched PDHG LP solver, ADMM prox-QP master,
             dual-vertex crossover
  sd/        the SD algorithm: dual pool, cuts/epigraphs, incumbent logic,
             prox-weight schedules, the jitted iteration, driver loop
  parallel/  device mesh construction + sharding specs
  utils/     config, metrics, checkpointing, profiling, CLI
"""

__version__ = "0.1.0"

from sqlp_tpu.config import SDConfig  # noqa: F401
