"""Backend validation matrix: run each mode on every available backend /
arithmetic combination and compare residues and factors across them.

Analog of the reference's backend validation matrix
(reference: tests/run_backend_validation_matrix.sh, README.md:234-249 —
profiles x {Auto, Aevum, Marin, internal} x modes, residue/factor
comparison, summary.tsv). Here the combos are backend {numpy, jax} x
arith {gl64, fft3161}, all in this one process on JAX's default device;
fixed seeds so every backend runs the same curves.

Usage:
    python tools/validation_matrix.py [quick|standard] [out.tsv]

Exit code 0 iff every case agrees across all backends that ran it.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cases(profile: str):
    yield "prp", dict(exponent=9941, mode="prp", proof=False)
    yield "llsafe", dict(exponent=521, mode="llsafe")
    yield "pm1_s1", dict(exponent=541, mode="pm1", b1=899)
    yield "ecm_edwards", dict(exponent=37, mode="ecm", b1=20, b2=400,
                              curves=6, curve_seed=5)
    if profile != "quick":
        yield "prp_cofactor", dict(exponent=2699, mode="prp", proof=False,
                                   known_factors=("5399", "307687",
                                                  "1187561",
                                                  "7570504839257",
                                                  "1987104667810711"))
        yield "llsafe2", dict(exponent=607, mode="llsafe2")
        yield "pm1_s2", dict(exponent=367, mode="pm1", b1=11981, b2=38971)
        yield "pm1_lowmem", dict(exponent=367, mode="pm1", b1=11981,
                                 b2=38971, pm1_variant="lowmem")
        yield "ecm_montgomery", dict(exponent=37, mode="ecm", b1=20,
                                     b2=400, curves=6, curve_seed=5,
                                     edwards=False)


BACKENDS = (("numpy", "gl64"), ("jax", "gl64"), ("numpy", "fft3161"))


def fingerprint(r) -> str:
    """The comparable outcome of a run: factor for factoring modes,
    res64/primality for tests."""
    f = getattr(r, "factor", 0)
    if f:
        return f"factor={f}"
    parts = []
    for attr in ("is_prime", "cofactor_prp", "res64"):
        v = getattr(r, attr, None)
        if v not in (None, ""):
            parts.append(f"{attr}={v}")
    return ",".join(parts) or "no-result"


def main() -> int:
    profile = sys.argv[1] if len(sys.argv) > 1 else "quick"
    out_path = sys.argv[2] if len(sys.argv) > 2 else ""
    from prmers_tpu.core.app import run_once
    from prmers_tpu.io.options import Options

    rows = []
    bad = 0
    for name, kw in cases(profile):
        seen = {}
        for backend, arith in BACKENDS:
            if arith == "fft3161" and name.startswith("ecm"):
                continue   # same engines, slow; gl64 covers the mode
            with tempfile.TemporaryDirectory() as td:
                o = Options(backend=backend, arith=arith, save_dir=td,
                            worktodo_path=os.path.join(td, "wt.txt"),
                            results_path=os.path.join(td, "r.txt"), **kw)
                t0 = time.perf_counter()
                try:
                    r, _ = run_once(o, log=lambda *a, **k: None)
                    fp = fingerprint(r)
                except Exception as e:   # noqa: BLE001 — recorded, not fatal
                    fp = f"ERROR:{type(e).__name__}:{e}"
                dt = time.perf_counter() - t0
            seen.setdefault(fp, []).append(f"{backend}/{arith}")
            rows.append((name, f"{backend}/{arith}", fp, f"{dt:.1f}"))
            print(f"{name:16s} {backend}/{arith:10s} {dt:7.1f}s  {fp}")
        if len(seen) != 1:
            bad += 1
            print(f"MISMATCH in {name}: {seen}", file=sys.stderr)
    if out_path:
        with open(out_path, "w") as f:
            f.write("case\tbackend\toutcome\tseconds\n")
            for row in rows:
                f.write("\t".join(row) + "\n")
        print(f"summary written to {out_path}")
    print(f"{'OK' if not bad else 'FAIL'}: {len(rows)} runs, "
          f"{bad} mismatched cases")
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
