"""chip_smoke.py: its phase functions at tiny exponents on the CPU, its
refusal to run without a GPU, and (marked gpu) its width phase on a card."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("p", [9941, 2203])     # n = 512 and n = 80
def test_width_phase(p, capsys):
    cs.phase_width(p)
    out = capsys.readouterr().out
    assert "bit-exact" in out and "memory_analysis" in out


def test_width_chain_matches_numpy_oracle():
    """The chain agrees between the big-int model and the numpy engine,
    the two references the width phase may use."""
    import numpy as np
    from prmers_tpu.engine.np_engine import NumpyEngine
    p = 1279
    ref, npe = cs.BigIntRef(p, 8), NumpyEngine(p, 8)
    regs = [cs.width_chain(e, 123456789, 987654321) for e in (ref, npe)][0]
    for r in regs:
        assert np.array_equal(ref.get_digits(r), npe.get_digits(r)), r


def test_prp_phase_resumes(tmp_path, capsys):
    cs.phase_prp(9941, str(tmp_path))
    out = capsys.readouterr().out
    assert "Resuming from a checkpoint" in out
    assert not (tmp_path / "results.txt").exists()


@pytest.mark.parametrize("name", ["prp M9941", "ll M127", "pm1 M367"])
def test_golden(name, capsys):
    cs.phase_goldens([name])
    assert f"[goldens] {name}:" in capsys.readouterr().out


def test_four_phase_on_virtual_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cs.phase_four(9941, 4)


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_fails_without_gpu(args):
    r = _run(REPO, *args)
    assert r.returncode != 0
    assert not _printed_result(r.stdout)
    assert "no GPU" in r.stderr


def test_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert not _printed_result(r.stdout)


@pytest.mark.gpu
def test_width_phase_on_gpu(gpu):
    cs.phase_width(cs.P_FLAGSHIP)
