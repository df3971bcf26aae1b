"""Autotuning cache: measured iteration rates per transform size.

The reference persists `tune.txt` / `ztune.txt` throughput+capacity tables
that plan selection consults (reference: third_party/aevum/tune.cpp,
TuneEntry.cpp, tune.h:18-30). Here `-tune` measures PRP iter/s per
transform size on the attached device and persists prmers_tune.json; the
arithmetic-path policy consults it. Records are keyed by the device kind
they were measured on, and only the attached kind's records are read, so
rates from one card never decide for another. ROE-based capacity tuning
(ztune) does not apply — the integer NTT is exact; capacity is the static
convolution bound from the plan.

File layout: {device_kind: {str(n): {engine class name: best iter/s}}}.
"""

from __future__ import annotations

import json
import os
import time

TUNE_FILE = "prmers_tune.json"

# the reference's benchmark exponent ladder, truncated to sizes a single
# chip can set up quickly (reference: src/core/App.cpp:670-674)
TUNE_EXPONENTS = (127, 9941, 216091, 756839, 3021377, 25964951,
                  57885161, 136279841)


def tune_path(save_dir: str = ".") -> str:
    return os.path.join(save_dir, TUNE_FILE)


def device_kind() -> str:
    """The attached device's kind, as JAX reports it."""
    from .. import jaxconf  # noqa: F401
    import jax
    return jax.devices()[0].device_kind


def _load_all(save_dir: str) -> dict:
    try:
        with open(tune_path(save_dir)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def load(save_dir: str = ".", kind: str | None = None) -> dict:
    """{str(n): {engine: ips}} measured on `kind` (default: attached)."""
    ent = _load_all(save_dir).get(kind or device_kind(), {})
    return ent if isinstance(ent, dict) else {}


def record(n: int, backend: str, ips: float, save_dir: str = ".",
           kind: str | None = None) -> None:
    data = _load_all(save_dir)
    ent = data.setdefault(kind or device_kind(), {}).setdefault(str(n), {})
    ent[backend] = max(float(ips), ent.get(backend, 0.0))  # keep the best
    with open(tune_path(save_dir), "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)


def lookup(n: int, backend: str, save_dir: str = ".",
           kind: str | None = None) -> float:
    return float(load(save_dir, kind).get(str(n), {}).get(backend, 0.0))


def measure_ips(eng, iters: int = 64, warm: int = 8) -> float:
    """Iterations/second of the PRP squaring chain on an engine.

    The warm-up chain must have the SAME length as the timed one — the
    sequence ops specialize on the chain length, so a different warm
    length would leave the compile inside the timed region."""
    eng.set(0, 3)
    eng.square_mul_seq(0, [1] * iters)
    eng.sync()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * iters)
    eng.sync()
    return iters / (time.perf_counter() - t0)


def run_tune(opts, log=print):
    """Measure every ladder size on the attached device — BOTH arithmetic
    paths — and persist, so the auto policy's measured branch becomes
    live (reference: tune.txt consulted by bestFit,
    third_party/aevum/tune.cpp)."""
    from ..engine.factory import create_engine

    iters = opts.bench_iters or 64
    results = {}
    ariths = ("gl64", "fft3161") if getattr(opts, "arith", "auto") == \
        "auto" else (opts.arith,)
    for p in TUNE_EXPONENTS:
        if opts.exponent and p > opts.exponent:
            break
        for arith in ariths:
            try:
                eng = create_engine(p, 2, backend=opts.backend,
                                    arith=arith)
            except Exception as e:  # noqa: BLE001 — skip unfittable sizes
                log(f"tune: skip p={p} {arith}: {e}")
                continue
            try:
                ips = measure_ips(eng, iters=iters)
            except Exception as e:  # noqa: BLE001
                log(f"tune: measure failed p={p} {arith}: {e}")
                del eng
                continue
            n = eng.get_size()
            record(n, type(eng).__name__, ips, opts.save_dir)
            results[(p, arith)] = ips
            log(f"tune: p={p} {arith} n={n} {ips:.2f} iter/s")
            del eng
    return results
