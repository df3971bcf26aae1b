"""Engine choice, device register budget, device-keyed tune records and the
compile-cache location: all decided from what the code can observe."""

import json
import os
import subprocess
import sys

import pytest

from prmers_tpu.core import tune
from prmers_tpu.engine import factory, paged

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeDevice:
    def __init__(self, platform, kind, stats=None):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


H100 = FakeDevice("gpu", "NVIDIA H100 80GB HBM3",
                  {"bytes_limit": 63763120128, "bytes_in_use": 0})


@pytest.fixture
def on_platform(monkeypatch, request):
    import jax
    dev = {"gpu": H100,
           "rocm": FakeDevice("rocm", "some other accelerator"),
           "cpu": FakeDevice("cpu", "cpu")}[request.param]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev] * 4)
    return dev


# ---------------------------------------------------------------------------
# engine choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("on_platform", ["gpu", "rocm", "cpu"],
                         indirect=True)
@pytest.mark.parametrize("p,cls", [(136279841, "JaxEngine"),
                                   (9941, "JaxEngine"),
                                   (1_200_000_001, "JaxRowEngine")])
def test_auto_choice_ignores_platform(on_platform, p, cls, tmp_path,
                                      monkeypatch):
    monkeypatch.chdir(tmp_path)          # no tune file
    b, a = factory.resolve(p, "auto", workload="prp")
    assert (b, a) == ("jax", "gl64")
    assert factory.engine_class(p, b, a).__name__ == cls


@pytest.mark.parametrize("backend,arith,cls", [
    ("sharded", None, "ShardedEngine"),
    ("numpy", None, "NumpyEngine"),
    ("jax", "fft3161", "Engine3161"),
    ("auto", "fft3161", "Engine3161"),
])
def test_explicit_backends(backend, arith, cls):
    b, a = factory.resolve(136279841, backend, arith)
    assert factory.engine_class(136279841, b, a).__name__ == cls


def test_pallas_backend_rejected():
    with pytest.raises(ValueError, match="unknown backend"):
        factory.configure_backend("pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        factory.create_engine(9941, 2, backend="pallas")
    from prmers_tpu.io.cli import parse_args
    with pytest.raises(SystemExit):
        parse_args(["9941", "-backend", "pallas"])


def test_small_budget_pages_to_host(monkeypatch):
    from prmers_tpu.engine.paged import PagedEngine
    monkeypatch.setenv("PRMERS_MAX_DEVICE_REGS", "2")
    eng = factory.create_engine(127, 6, backend="jax")
    assert isinstance(eng, PagedEngine) and eng.slots == 2
    eng.set_int(5, 12345)
    eng.square_mul(5)
    assert eng.get_int(5) == 12345 ** 2 % ((1 << 127) - 1)


# ---------------------------------------------------------------------------
# device register budget
# ---------------------------------------------------------------------------

def test_budget_from_gpu_memory_stats(monkeypatch):
    monkeypatch.delenv("PRMERS_MAX_DEVICE_REGS", raising=False)
    monkeypatch.delenv("PRMERS_MEMLIM_MB", raising=False)
    n = 1 << 23
    got = paged.device_reg_budget(n, device=H100)
    assert got == int(63763120128 * 0.95) // (8 * n) - 11


def test_budget_cpu_uses_host_memory(monkeypatch):
    monkeypatch.delenv("PRMERS_MAX_DEVICE_REGS", raising=False)
    monkeypatch.delenv("PRMERS_MEMLIM_MB", raising=False)
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert paged.device_memory_bytes(FakeDevice("cpu", "cpu")) == host


def test_budget_unknown_device_is_an_error(monkeypatch):
    monkeypatch.delenv("PRMERS_MAX_DEVICE_REGS", raising=False)
    monkeypatch.delenv("PRMERS_MEMLIM_MB", raising=False)
    with pytest.raises(RuntimeError, match="no memory limit"):
        paged.device_reg_budget(1 << 20, device=FakeDevice("gpu", "x"))


def test_budget_memlim_overrides_device(monkeypatch):
    monkeypatch.delenv("PRMERS_MAX_DEVICE_REGS", raising=False)
    monkeypatch.setenv("PRMERS_MEMLIM_MB", "1024")
    n = 1 << 20
    assert paged.device_reg_budget(n, device=H100) == \
        max(int((1024 << 20) * 0.95) // (8 * n) - 11, 2)


# ---------------------------------------------------------------------------
# tune records keyed by device kind
# ---------------------------------------------------------------------------

def test_tune_records_keyed_by_kind(tmp_path):
    d = str(tmp_path)
    tune.record(512, "JaxEngine", 100.0, d, kind="NVIDIA H100 80GB HBM3")
    tune.record(512, "JaxEngine", 7.0, d, kind="cpu")
    assert tune.lookup(512, "JaxEngine", d, kind="NVIDIA H100 80GB HBM3") \
        == 100.0
    assert tune.lookup(512, "JaxEngine", d) == 7.0      # attached: cpu
    data = json.loads((tmp_path / tune.TUNE_FILE).read_text())
    assert set(data) == {"NVIDIA H100 80GB HBM3", "cpu"}


def test_policy_ignores_other_kinds(tmp_path):
    from prmers_tpu.engine.policy import decide_arith
    d = str(tmp_path)
    d0 = decide_arith(756839, "prp", d)
    tune.record(d0.n_gl64, "JaxEngine", 1.0, d, kind="other card")
    tune.record(d0.n_3161, "Engine3161", 1000.0, d, kind="other card")
    assert decide_arith(756839, "prp", d).arith == "gl64"
    tune.record(d0.n_gl64, "JaxEngine", 1.0, d)
    tune.record(d0.n_3161, "Engine3161", 1000.0, d)
    assert decide_arith(756839, "prp", d).arith == "fft3161"


def test_unkeyed_legacy_file_ignored(tmp_path):
    (tmp_path / tune.TUNE_FILE).write_text(
        json.dumps({"512": {"JaxEngine": 99.0}}))
    assert tune.load(str(tmp_path)) == {}
    assert tune.lookup(512, "JaxEngine", str(tmp_path)) == 0.0


# ---------------------------------------------------------------------------
# compile cache location
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_dir", [None, "cache_here"])
def test_jaxconf_cache_dir(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "from prmers_tpu import jaxconf; import jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=dict(env, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == want
