"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phases hold at tiny sizes against the same HiGHS and scipy references it
uses on the card (this catches wiring errors without a card)."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

from conftest import require_instance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _run_script(cwd, env_over):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_over)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_gpu():
    out = _run_script(REPO, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs 1 GPU" in out.stderr


def test_refuses_outside_the_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(tmp_path, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("name", ["lands", "transship"])
def test_lp_panel_phase(name):
    require_instance(name)
    out = cs.phase_lp_panel(name, 8)
    assert out["checked"] == 8 and out["valid"] == 8
    assert out["obj_rel_err_max"] <= cs.LP_OBJ_RTOL
    assert out["dual_infeas_max"] <= cs.LP_DUAL_TOL


def test_lp_panel_phase_rejects_a_wrong_dual(monkeypatch):
    """The dual check is live: a kernel that returned sign-flipped duals
    would be caught."""
    require_instance("lands")
    from sqlp_tpu.ops import pdhg

    real = pdhg.solve_batch

    def flipped(*a, **k):
        obj, Y, Pi, st = real(*a, **k)
        return obj, Y, -Pi, st

    monkeypatch.setattr(pdhg, "solve_batch", flipped)
    with pytest.raises(RuntimeError, match="cone|dual"):
        cs.phase_lp_panel("lands", 8)


def test_master_qp_phase():
    out = cs.phase_master_qp()
    assert set(out) == {"compqp", "compqp2", "compqp3",
                        "master_qp_warm_stall_lands"}
    for rec in out.values():
        assert rec["obj_rel_err"] <= cs.QP_OBJ_RTOL


def test_cli_phase():
    require_instance("lands")
    out = cs.phase_cli(["solve", "lands", "--iters", "200", "--x0",
                        "crash", "--eval-every", "100"],
                       optimum=cs.LANDS_OPT)
    assert abs(out["lb_est"] - cs.LANDS_OPT) < cs.LANDS_SPREAD
