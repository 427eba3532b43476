"""Process-level JAX configuration, applied explicitly by entry points.

Previously these updates ran as a side effect of importing
``sqlp_tpu.sd.driver``, which mutated global JAX state (default dtypes,
compilation-cache paths) for any unrelated code sharing the process
(ADVICE r1). Entry points — the CLI, the SDSolver constructor, the bench
harness, ``chip_smoke.py`` — now call :func:`configure_jax` at startup
instead.
"""

from __future__ import annotations

import hashlib
import os

_configured = False

# <checkout>/.jax_cache: a fixed path (the cache key includes the path, so
# a directory that moves never hits), listed in .gitignore.
DEFAULT_CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def _cpu_fingerprint() -> str:
    """Short hash of the host CPU's feature flags.

    The cache key does NOT include the host CPU's feature set, but
    XLA:CPU stores AOT-compiled executables: an entry written on a
    machine with (say) AMX/AVX10 loads on a host without them and
    executes illegal instructions ("Loading XLA:CPU AOT result ... could
    lead to execution errors such as SIGILL"). One subdirectory per
    machine class keeps them apart.
    """
    try:
        with open("/proc/cpuinfo") as fh:
            flags = next((ln for ln in fh if ln.startswith("flags")), "")
    except OSError:
        return "nocpuinfo"
    return hashlib.sha1(flags.encode()).hexdigest()[:10]


def configure_jax() -> None:
    """Idempotent; safe to call from every entry point.

    - Persistent compilation cache: the jitted sd_step is a large graph;
      cache compilations across processes. Where
      ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
      other location is set here; otherwise the cache lives under
      :data:`DEFAULT_CACHE_ROOT`, one subdirectory per CPU fingerprint.
    - x64: enables the f64 master-QP path inside solve_qp (storm-scale
      masters are not solvable to per-row feasibility in f32); all other
      state keeps the configured dtype — literals stay weakly typed under
      JAX promotion.
    - Matmul precision "highest", process-wide: every f32 product runs at
      full f32. On the GPU the default lets f32 products run in TF32
      (~10 mantissa bits), which can flip argmax winners and perturb cut
      coefficients; explicit ``precision=`` pins still win where present.

    Set SQLP_TPU_NO_JAX_CONFIG=1 to leave global JAX config untouched
    (embedding in a process that manages its own config).
    """
    global _configured
    if _configured or os.environ.get("SQLP_TPU_NO_JAX_CONFIG"):
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(DEFAULT_CACHE_ROOT, _cpu_fingerprint()))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    _configured = True
