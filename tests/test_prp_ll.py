import random

import pytest

from prmers_tpu.core import results as res
from prmers_tpu.engine.factory import create_engine
from prmers_tpu.io.options import Options
from prmers_tpu.modes.prp_ll import run_prp_or_ll


def opts_for(p, tmp_path, **kw):
    o = Options(exponent=p, save_dir=str(tmp_path), proof=False,
                verbose=False, backup_interval=1e9)
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def quiet(*a, **k):
    pass


def test_ll_m127(tmp_path):
    r = run_prp_or_ll(opts_for(127, tmp_path, mode="ll"), log=quiet)
    assert r.is_prime


def test_ll_composite(tmp_path):
    # M1277 is composite (no factor known, famous candidate)
    r = run_prp_or_ll(opts_for(1277, tmp_path, mode="ll"), log=quiet)
    assert not r.is_prime


@pytest.mark.parametrize("p,prime", [(521, True), (607, True), (1009, False)])
def test_prp(p, prime, tmp_path):
    r = run_prp_or_ll(opts_for(p, tmp_path, mode="prp"), log=quiet)
    assert r.is_prime == prime
    # verify residue against direct python-int computation
    mp = (1 << p) - 1
    x = pow(3, 1 << p, mp)
    expect = res.prp_residue(p, x)
    assert r.res64 == res.res64_hex(expect)
    assert r.res2048 == res.res2048_hex(expect)
    if prime:
        assert r.res64 == "0000000000000001"


def test_quickcheck(tmp_path):
    r = run_prp_or_ll(opts_for(61, tmp_path, mode="prp"), log=quiet)
    assert r.quick and r.is_prime
    r = run_prp_or_ll(opts_for(97, tmp_path, mode="ll"), log=quiet)
    assert r.quick and not r.is_prime


def test_gerbicz_error_injection(tmp_path):
    msgs = []
    o = opts_for(1279, tmp_path, mode="prp", erroriter=55, checklevel=1)
    r = run_prp_or_ll(o, log=lambda *a: msgs.append(" ".join(map(str, a))))
    assert r.is_prime  # M1279 is prime; error must be caught and corrected
    assert r.gerbicz_errors >= 1
    joined = "\n".join(msgs)
    assert "Injected error" in joined
    assert "Check FAILED" in joined
    assert "Restore iter=" in joined
    assert r.res64 == "0000000000000001"


def test_checkpoint_resume(tmp_path):
    p = 521
    # interrupt partway through by wrapping the engine
    eng = create_engine(p, 8, backend="jax")
    orig = eng.square_mul_seq
    calls = {"n": 0}

    def hook(src, a_vec):
        if calls["n"] >= 5:
            raise KeyboardInterrupt
        calls["n"] += 1
        return orig(src, a_vec)

    eng.square_mul_seq = hook
    o = opts_for(p, tmp_path, mode="prp", backup_interval=0.0)
    r1 = run_prp_or_ll(o, eng=eng, log=quiet)
    assert r1.interrupted and 0 < r1.iteration < p

    # fresh engine resumes from checkpoint and finishes correctly
    o2 = opts_for(p, tmp_path, mode="prp")
    msgs = []
    r2 = run_prp_or_ll(o2, log=lambda *a: msgs.append(" ".join(map(str, a))))
    assert any("Resuming" in m for m in msgs)
    assert r2.is_prime and r2.res64 == "0000000000000001"


def test_wagstaff(tmp_path):
    # (2^q + 1)/3 for q=61: wagstaff prime? q=61 is a known Wagstaff prime.
    o = opts_for(122, tmp_path, mode="prp", wagstaff=True)
    r = run_prp_or_ll(o, log=quiet)
    assert r.wagstaff_prp is True
    # q=67 is NOT a Wagstaff prime exponent... 67: known Wagstaff primes
    # include 3,5,7,11,13,17,19,23,31,43,61,79,101,127,...; 67 absent.
    o = opts_for(134, tmp_path, mode="prp", wagstaff=True)
    r = run_prp_or_ll(o, log=quiet)
    assert r.wagstaff_prp is False


@pytest.mark.slow
def test_m100003_golden_res64_res2048():
    """Reference unit_tests.sh:136-148 bit-exact residue literals."""
    from prmers_tpu.core import results as res
    o = Options(exponent=100003, mode="prp", backend="numpy", proof=False)
    r = run_prp_or_ll(o, log=lambda *a: None)
    assert not r.is_prime
    assert r.res64 == "1CF45E9503C71FD6"
    assert r.res2048.lower().endswith("1cf45e9503c71fd6")
    assert r.res2048.lower() == (
        "af262d00ed00a05d53e99d0e0e451b12405ddabe139fe8396a4c520b505bb65b"
        "ed1609d3c8ef23bbb1d0f8140a6bcdd2c67f9c8aa3bd0e6eeb3e8e79db904810"
        "c88de09820557176b389290f84f18424efa6a59fb9f132a74f53a83ba6e2f508"
        "c617a5e1451c3ee08d179e6614026f973d1900602f2068a08894cd81ed5035de"
        "9ded85909b1ee6ff4dc723118b79d3f940272ae1066aebe27c86338ad7edf70e"
        "76c0e8abf3e985b73db2a06f1b742a9a908728be2bd4b7daa2d6aafc11bacaaa"
        "40944e9a66b039cb0deaaa8e5e357cd54b81b3ec6661d55e48bacb994bfd3cbb"
        "33f3f01d82347fa00578ec86c4cd7eb568a1463cf3e38dae1cf45e9503c71fd6")


@pytest.mark.heavy
def test_m11213_interval_res64_stream():
    """Reference unit_tests.sh:163-186: intermediate res64 every 1000
    iterations must match the golden stream bit-exactly."""
    golden = {
        1000: "FBA631FBCB73A011", 2000: "F01283650C4A1491",
        3000: "7E79193B757010B7", 4000: "31482E4D80FE99BB",
        5000: "973B76BACF73BBEF", 6000: "8CFFB332495FC320",
        7000: "98080C76DF068843", 8000: "8FDA516F885D3FEE",
        9000: "2AADBC4F1E318E92", 10000: "0A4AAF339C8B290C",
        11000: "A1F26F470CFE412D",
    }
    logs = []
    o = Options(exponent=11213, mode="prp", backend="numpy", proof=False,
                res64_display_interval=1000)
    r = run_prp_or_ll(o, log=lambda *a: logs.append(" ".join(map(str, a))))
    assert r.is_prime
    seen = {}
    for line in logs:
        if "Res64:" in line and "Iter:" in line:
            it = int(line.split("Iter:")[1].split("|")[0].strip())
            seen[it] = line.split("Res64:")[1].strip()
    for it, want in golden.items():
        assert seen.get(it) == want, (it, seen.get(it))


@pytest.mark.parametrize("from_worktodo", [False, True])
def test_interrupted_run_writes_no_result(tmp_path, from_worktodo):
    """An interrupt saves a checkpoint and ends the run: no result line is
    written and a worktodo entry stays queued for the resume."""
    from prmers_tpu.core.app import run_app
    wt = tmp_path / "worktodo.txt"
    if from_worktodo:
        wt.write_text("PRP=1,2,9941,-1\n")
    o = opts_for(0 if from_worktodo else 9941, tmp_path, mode="prp",
                 checklevel=1, worktodo_path=str(wt),
                 results_path=str(tmp_path / "results.txt"))

    def stop_at_gl(*a, **k):
        if "Check passed" in " ".join(map(str, a)):
            raise KeyboardInterrupt

    assert run_app(o, log=stop_at_gl) == 1
    assert not (tmp_path / "results.txt").exists()
    assert (tmp_path / "m_9941.ckpt").exists()
    if from_worktodo:
        assert "9941" in wt.read_text()
