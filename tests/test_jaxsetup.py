"""configure_jax(): compile-cache location and process-wide precision.

Each case runs in a fresh interpreter: configure_jax is idempotent per
process and the test process has already fixed its own JAX config.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, jax
from sqlp_tpu.utils.jaxsetup import DEFAULT_CACHE_ROOT, configure_jax
configure_jax()
print(json.dumps({
    "cache_dir": jax.config.jax_compilation_cache_dir,
    "default_root": DEFAULT_CACHE_ROOT,
    "precision": str(jax.config.jax_default_matmul_precision),
    "x64": bool(jax.config.jax_enable_x64)}))
"""


def _probe(**env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "SQLP_TPU_NO_JAX_CONFIG")}
    env.update(env_over, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cache_dir_from_environment(tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is where the cache lives."""
    want = str(tmp_path / "cache")
    got = _probe(JAX_COMPILATION_CACHE_DIR=want)
    assert got["cache_dir"] == want


def test_cache_dir_default_inside_checkout():
    """Unset, the cache lives at one fixed path inside the checkout, in a
    directory .gitignore lists."""
    got = _probe()
    root = os.path.join(REPO, ".jax_cache")
    assert got["default_root"] == root
    assert os.path.dirname(got["cache_dir"]) == root
    with open(os.path.join(REPO, ".gitignore")) as fh:
        ignored = {ln.strip().strip("/") for ln in fh}
    assert ".jax_cache" in ignored


def test_full_f32_matmuls_and_x64():
    """Every f32 product runs at full precision (no TF32 on the GPU), and
    x64 is on for the f64 master and certificate paths."""
    got = _probe()
    assert got["precision"] == "highest"
    assert got["x64"] is True
