"""Multi-process (multi-host) initialization.

The reference has no distributed backend at all — parallelism exists only
as comments (src/sd_algorithm/algorithm.jl:7-11). SURVEY.md §5.8 specifies
the equivalent: ``jax.distributed.initialize()`` + a device mesh
spanning (hosts x local devices), with the SD step written in global
view so XLA inserts the cross-host collectives (the scenario-store argmax
reduction and the dual-pool gather ride the same psum/all-gather paths
single-host sharding already exercises).

Call :func:`init_distributed` once per process, BEFORE any JAX backend
query, then build meshes with ``parallel.mesh.make_mesh()`` as usual —
``jax.devices()`` is the global device list after initialization.

One process drives all the GPUs of its host: launch one process per
host, not one per GPU. Where several processes must share a host, each
needs its own devices (``jax.distributed.initialize(...,
local_device_ids=...)``); otherwise every process opens (and reserves
memory on) every GPU of the host. On CPU (tests)
``cpu_devices_per_process`` forces a virtual local device count and
cross-process collectives run over Gloo.
"""

from __future__ import annotations

import os
from typing import Optional


def init_distributed(coordinator_address: str,
                     num_processes: int,
                     process_id: int,
                     cpu_devices_per_process: Optional[int] = None,
                     platform: Optional[str] = None) -> None:
    """Initialize this process's slot in the distributed runtime.

    Args:
      coordinator_address: ``host:port`` of process 0's coordinator.
      num_processes: total process count.
      process_id: this process's rank in [0, num_processes).
      cpu_devices_per_process: CPU-backend testing — force this many
        virtual local devices (XLA host-platform flag; must run before the
        backend initializes) and enable Gloo cross-process collectives.
      platform: force a jax platform (e.g. "cpu") before the backend
        initializes.
    """
    if cpu_devices_per_process is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{cpu_devices_per_process}").strip()
        platform = platform or "cpu"

    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    if (platform or "").startswith("cpu") or cpu_devices_per_process:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def is_multiprocess() -> bool:
    import jax
    return jax.process_count() > 1
