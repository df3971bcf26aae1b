"""GL-window smoke: run each ladder exponent's PRP until its FIRST
Gerbicz-Li check passes, then stop and move on.

Analog of the reference's unit_test_all.sh (27 exponents,
each killed after the first "[Gerbicz Li] Check passed" appears in the
log) — validates every transform size's first verified window without a
full run. Usage:

    python tools/gl_smoke.py [max_exponent]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _FirstGlPass(Exception):
    pass


def smoke_one(p: int) -> tuple[bool, float, str]:
    """(ok, seconds, detail) — ok when the first GL window verifies."""
    import tempfile
    from prmers_tpu.io.options import Options
    from prmers_tpu.modes.prp_ll import run_prp_or_ll

    seen = {}

    def log(msg, *a, **k):
        m = str(msg)
        if "[Gerbicz Li] Check passed" in m:
            seen["pass"] = m
            raise KeyboardInterrupt   # the mode saves + exits cleanly
        if "Check FAILED" in m:
            seen["fail"] = m

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        o = Options(exponent=p, mode="prp", proof=False, save_dir=td,
                    checklevel=1)
        try:
            run_prp_or_ll(o, log=log)
        except KeyboardInterrupt:
            pass
        except Exception as e:   # noqa: BLE001 — a broken shape must
            # record FAIL and let the rest of the ladder run (repeated
            # GL failure raises RuntimeError; that is the very signal
            # this tool exists to catch)
            return False, time.perf_counter() - t0, \
                f"{type(e).__name__}: {e}"
    dt = time.perf_counter() - t0
    if "fail" in seen:
        return False, dt, seen["fail"]
    if "pass" in seen:
        return True, dt, seen["pass"]
    return True, dt, "run completed before any GL window"


def main() -> int:
    from prmers_tpu.modes.bench import BENCH_EXPONENTS
    cap = int(sys.argv[1]) if len(sys.argv) > 1 else 10 ** 18
    bad = 0
    for p in BENCH_EXPONENTS:
        if p > cap:
            continue
        ok, dt, detail = smoke_one(p)
        print(f"M{p:<12} {'OK' if ok else 'FAIL':4s} {dt:7.1f}s  {detail}")
        bad += 0 if ok else 1
    print("GL smoke:", "ALL OK" if not bad else f"{bad} FAILURES")
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
