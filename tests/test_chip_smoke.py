"""chip_smoke.py: its refusal without a GPU, and each of its phases at the
tiny_test size on the CPU (the card runs them at full size)."""

import importlib
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(REPO)


def _run(args, cwd, env):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu_only_device():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = _run([SCRIPT], REPO, env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(SCRIPT, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run([str(tmp_path / "chip_smoke.py")], str(tmp_path), env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_parity_phase_tiny(smoke):
    out = smoke.phase_parity([("9x9", 8)])
    assert out["9x9"]["prob_diff"] <= smoke.BF16_PROB_TOL
    assert out["golden/19x19_10b"]["logit_diff"] <= smoke.GOLDEN_ATOL


def test_search_phase_tiny(smoke):
    out = smoke.phase_search(oracle_size=5, oracle_sims=20, oracle_envs=2,
                             preset="tiny_test", num_envs=4, plies=4)
    assert out["oracle_visits_equal"] and out["argmax_agreement"] == 1.0


def test_train_phase_tiny(smoke, tmp_path):
    out = smoke.phase_train("tiny_test", str(tmp_path))
    assert out["checkpoints"] == [2, 3]


def test_bench_eval_phase_tiny(smoke):
    out = smoke.phase_bench_eval("tiny_test", 2, 2, 8)
    assert out["eval"]["games"] == 2 and out["bench"]["plies"] == 2


def test_four_cards_phase_on_four_cpu_devices(smoke, tmp_path):
    out = smoke.phase_four_cards("tiny_test", str(tmp_path), n=4)
    assert out["replicas_identical"]
    assert out["learner_step_max_diff"] <= smoke.STEP_ATOL


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    out = subprocess.run([sys.executable, SCRIPT], cwd=REPO, env=gpu,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
