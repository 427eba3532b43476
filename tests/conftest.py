"""Test configuration.

Tests run on a virtual 8-device CPU mesh (multi-device sharding is
validated without an accelerator, per SURVEY.md §4) with x64 enabled so
golden-value comparisons against the reference's Float64 semantics are
exact where the reference asserts exactness.
"""

import os
import resource

# Raise the stack ceiling (default soft limit: 8 MB). XLA's CPU pipeline
# recurses deeply while compiling the largest graph in the suite (sd_run's
# chunked scan over the full SD step); two suite runs segfaulted inside
# native compile/serialize frames with 125 GB of RAM free — the signature
# of main-thread stack exhaustion, which Linux reports as SIGSEGV. The
# main stack grows on demand up to the soft limit, so raising it here
# (before any deep compile) takes effect for the whole run.
_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
# A large FINITE soft limit, not RLIM_INFINITY: glibc sizes new pthread
# stacks from the soft limit ONLY when it is finite — "unlimited" falls
# back to the small built-in default, so raising to infinity leaves
# XLA's compile threads on ~8 MB stacks (the previous fix's remaining
# flake). 512 MB is virtual address space, lazily paged.
_want = 512 << 20
# ... including LOWERING an "unlimited" soft limit to the finite value:
# glibc treats RLIM_INFINITY as "use the small built-in default" when
# sizing pthread stacks, so unlimited is the broken case, not the good
# one.
if _soft == resource.RLIM_INFINITY or _soft < _want:
    if _hard != resource.RLIM_INFINITY:
        _want = min(_want, _hard)
    try:
        resource.setrlimit(resource.RLIMIT_STACK, (_want, _hard))
    except (ValueError, OSError):
        pass

# Raise the memory-map ceiling: one long-lived pytest process JIT-loads
# hundreds of XLA:CPU executables, each landing several mmaps per LLVM
# codegen split (~6+ maps even for a tiny jit; the sd_run/evaluator
# programs land hundreds). The kernel default vm.max_map_count=65530
# exhausts roughly 30 tests in, at which point LLVM reports "Cannot
# allocate memory" and the process dies with SIGSEGV/SIGABRT mid-compile
# (the suite's long-standing flaky crash — reproduced with capture off).
# Writable as root (this image); best-effort elsewhere. The previous value
# is restored at session teardown (pytest_sessionfinish below) so running
# the tests does not permanently reconfigure the host kernel.
_prev_max_map_count = None
try:
    with open("/proc/sys/vm/max_map_count") as _fh:
        _cur = int(_fh.read())
    if _cur < 1_048_576:
        with open("/proc/sys/vm/max_map_count", "w") as _fh:
            _fh.write("1048576")
        _prev_max_map_count = _cur
except OSError:
    pass


def pytest_sessionfinish(session, exitstatus):
    if _prev_max_map_count is not None:
        try:
            with open("/proc/sys/vm/max_map_count", "w") as _fh:
                _fh.write(str(_prev_max_map_count))
        except OSError:
            pass

# Force CPU with jax.config.update (it wins over any JAX_PLATFORMS in the
# environment, so a machine with a GPU still runs the suite on the CPU).
# XLA_FLAGS for the virtual 8-device CPU mesh must be set before the cpu
# backend is first initialized (which happens lazily, so this ordering
# works).
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# No persistent compilation cache in tests: the suite compiles hundreds of
# small CPU executables in one long-lived process, and jax's cache-write
# path (compilation_cache.put_executable_and_time → executable
# serialization) has segfaulted there twice, killing the whole run. The
# cache only amortizes cross-process accelerator compiles, which tests
# never do; SDSolver's configure_jax() respects this pre-set flag.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from sqlp_tpu.models.instance import find_instance_dir  # noqa: E402


def require_instance(name: str) -> str:
    path = find_instance_dir(name)
    if path is None:
        pytest.skip(f"SMPS instance {name} not available")
    return path


@pytest.fixture(scope="session")
def lands_dir() -> str:
    return require_instance("lands")
