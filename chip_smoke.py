"""On-card smoke test: the main path once, at full width, on the GPU.

    python chip_smoke.py          # one GPU: device, width, prp, goldens
    python chip_smoke.py --four   # four GPUs: ShardedEngine vs one card

Phases (one GPU):
  device   the first JAX device must be a GPU (there is no CPU fallback);
           prints its kind, the device count and nvidia-smi's name and
           power limit.
  width    the factory's engine for p=136279841 (n=2^23) runs a chain of
           every op the PRP/P-1 loops use; each register is compared bit
           for bit with libgmp big-int arithmetic (the numpy oracle
           engine when libgmp is absent). Prints compile seconds,
           memory_analysis() and peak_bytes_in_use of the 256-squaring
           step.
  prp      the PRP of p=136279841 through the CLI entry (parse_args ->
           core/app) until the first Gerbicz-Li check passes; the saved
           checkpoint must resume, and the resumed residue must match
           big-int squarings of the checkpointed one.
  goldens  known answers through the mode drivers at small sizes.

With --four the script runs only the multi-card path: ShardedEngine over a
4-GPU 1-D mesh at p=136279841 against the same chain on one card.

Everything runs in this one process; the only child is nvidia-smi. Any
failure exits non-zero before the result line. The last line of standard
output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Times printed here are smoke figures, not benchmarks.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import re
import subprocess
import sys
import tempfile
import time

P_FLAGSHIP = 136279841      # wavefront PRP exponent, n = 2^23
SEED = 20261016
RESUME_STEPS = 4            # squarings the resumed run does before it stops


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class CompileClock:
    """Seconds XLA spent compiling, from JAX's own monitoring events."""

    def __init__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name: str, secs: float, **_kw) -> None:
        if name == "/jax/core/compile/backend_compile_duration":
            self.seconds += secs


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def phase_device(want: int) -> dict:
    import jax
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"[device] FAIL: JAX found no GPU (platform "
                         f"{d.platform!r}); this smoke runs only on the card")
    if len(devs) < want:
        raise SystemExit(f"[device] FAIL: {len(devs)} GPU(s), need {want}")
    from prmers_tpu import jaxconf  # noqa: F401  (x64 before any array)
    import jax.numpy as jnp
    if not jax.config.jax_enable_x64 or \
            jnp.zeros(1, jnp.uint64).dtype != jnp.uint64:
        raise SystemExit("[device] FAIL: x64 is off")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    from prmers_tpu.utils import gmp
    log("device", f"platform={d.platform} kind={d.device_kind} "
                  f"count={len(devs)} x64=on HAVE_GMP={gmp.HAVE_GMP}")
    for line in smi.strip().splitlines():
        log("device", f"nvidia-smi: {line.strip()}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# big-int reference
# ---------------------------------------------------------------------------

class BigIntRef:
    """The chain's Engine ops as libgmp big-int arithmetic mod M_p."""

    def __init__(self, p: int, reg_count: int):
        from prmers_tpu.core.plan import cached_plan
        self.p = p
        self.mp = (1 << p) - 1
        self.widths = cached_plan(p).widths
        self.r = [0] * reg_count

    def _mulmod(self, x: int, y: int, a: int = 1) -> int:
        from prmers_tpu.utils import gmp
        v = gmp.mersenne_mod(gmp.mul(x, y), self.p)
        return gmp.mersenne_mod(v * a, self.p) if a != 1 else v

    def set_int(self, dst: int, v: int) -> None:
        self.r[dst] = v % self.mp

    def square_mul(self, src: int, a: int = 1) -> None:
        self.r[src] = self._mulmod(self.r[src], self.r[src], a)

    def square_mul_seq(self, src: int, a_vec) -> None:
        for a in a_vec:
            self.square_mul(src, a)

    def set_multiplicand(self, dst: int, src: int) -> None:
        self.r[dst] = self.r[src]

    def mul(self, dst: int, src: int, a: int = 1) -> None:
        self.r[dst] = self._mulmod(self.r[dst], self.r[src], a)

    def sub(self, src: int, a: int) -> None:
        self.r[src] = (self.r[src] - a) % self.mp

    def addsub(self, sum_out: int, diff_out: int, a: int, b: int) -> None:
        x, y = self.r[a], self.r[b]
        self.r[sum_out] = (x + y) % self.mp
        self.r[diff_out] = (x - y) % self.mp

    def get_int(self, src: int) -> int:
        return self.r[src]

    def get_digits(self, src: int):
        from prmers_tpu.utils import digits as dg
        return dg.int_to_digits(self.r[src], self.widths)


def reference_engine(p: int, reg_count: int):
    """libgmp big-int where available, else the numpy oracle engine."""
    from prmers_tpu.utils import gmp
    if gmp.HAVE_GMP:
        return BigIntRef(p, reg_count)
    from prmers_tpu.engine.np_engine import NumpyEngine
    return NumpyEngine(p, reg_count)


def width_chain(e, x: int, y: int) -> tuple[int, ...]:
    """Every op the PRP/P-1 loops use; returns the digit registers."""
    mp = (1 << e.p) - 1
    e.set_int(0, x)
    e.set_int(1, y)
    e.square_mul_seq(0, [1, 3, 1, 1])   # squarings, one fast-3 step
    e.square_mul(0, 3)                  # the GL replay's x^2 * 3
    e.set_multiplicand(2, 1)
    e.mul(0, 2)
    e.sub(0, 2)                         # the LL / error-injection -2
    e.addsub(3, 4, 0, 1)
    e.set_int(5, mp - 1)                # edge value: (M_p - 1)^2 == 1
    e.square_mul(5)
    e.set_int(6, 0)                     # edge value: 0 stays 0
    e.square_mul(6)
    return (0, 1, 3, 4, 5, 6)


def _mismatch(got, want) -> str:
    import numpy as np
    bad = np.flatnonzero(np.asarray(got) != np.asarray(want))
    return f"{bad.size} digits differ, first at {bad[:4].tolist()}"


# ---------------------------------------------------------------------------
# width
# ---------------------------------------------------------------------------

def phase_width(p: int, clock: CompileClock | None = None) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from prmers_tpu.engine import jax_engine as je
    from prmers_tpu.engine.factory import create_engine

    t0 = time.perf_counter()
    eng = create_engine(p, 8, backend="auto", workload="prp")
    if type(eng) is not je.JaxEngine:
        raise AssertionError(f"factory gave {type(eng).__name__} for "
                             f"p={p}, expected JaxEngine")
    log("width", f"p={p} n={eng.get_size()} engine=JaxEngine "
                 f"(tables {time.perf_counter() - t0:.2f} s)")

    rnd = random.Random(SEED)
    mp = (1 << p) - 1
    x, y = rnd.randrange(mp), rnd.randrange(mp)
    c0 = clock.seconds if clock else 0.0
    t0 = time.perf_counter()
    regs = width_chain(eng, x, y)
    eng.sync()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = reference_engine(p, 8)
    width_chain(ref, x, y)
    log("width", f"chain on device {t_dev:.2f} s (compile "
                 f"{(clock.seconds if clock else 0.0) - c0:.2f} s), "
                 f"reference {type(ref).__name__} "
                 f"{time.perf_counter() - t0:.2f} s")
    for r in regs:
        got, want = eng.get_digits(r), ref.get_digits(r)
        if not np.array_equal(got, want):
            raise AssertionError(f"register {r}: {_mismatch(got, want)}")
    log("width", f"registers {list(regs)} bit-exact against "
                 f"{type(ref).__name__}")

    # the hot step: one dispatch of the chunked squaring chain
    k = eng._SEQ_CHUNK
    a = jnp.ones(k, dtype=jnp.uint64)
    t0 = time.perf_counter()
    compiled = je.op_square_mul_seq.lower(
        eng.regs, eng.t, jnp.int32(0), a).compile()
    log("width", f"op_square_mul_seq[{k}] compile "
                 f"{time.perf_counter() - t0:.2f} s")
    ma = compiled.memory_analysis()
    log("width", "memory_analysis: " + ", ".join(
        f"{f}={getattr(ma, f)}" for f in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes") if hasattr(ma, f)))
    eng.square_mul_seq(0, [1] * k)
    eng.sync()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * k)
    eng.sync()
    dt = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    log("width", f"smoke: {k} squarings in {dt:.3f} s = {k / dt:.1f} "
                 f"iter/s (one dispatch, not a benchmark); "
                 f"peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
                 f"bytes_limit={stats.get('bytes_limit')}")


# ---------------------------------------------------------------------------
# prp
# ---------------------------------------------------------------------------

def _run_cli(argv: list[str], stop_marker: str) -> list[str]:
    """parse_args -> run_app with a log that interrupts the run (as a
    user's Ctrl-C would) at the first line containing stop_marker."""
    from prmers_tpu.core.app import run_app
    from prmers_tpu.io.cli import parse_args
    seen: list[str] = []

    def _log(*args, **_kw):
        m = " ".join(str(a) for a in args)
        seen.append(m)
        log("prp", f"| {m}")
        if stop_marker in m:
            raise KeyboardInterrupt

    run_app(parse_args(argv), log=_log)
    return seen


def _find(lines: list[str], pattern: str) -> re.Match:
    for m in lines:
        hit = re.search(pattern, m)
        if hit:
            return hit
    raise AssertionError(f"no log line matches {pattern!r}")


def phase_prp(p: int, save_dir: str, clock: CompileClock | None = None
              ) -> None:
    import numpy as np
    from prmers_tpu.core import checkpoints as ck
    from prmers_tpu.core.plan import cached_plan
    from prmers_tpu.utils import digits as dg

    argv = [str(p), "-prp", "-checklevel", "1", "-save-dir", save_dir,
            "-worktodo", os.path.join(save_dir, "worktodo.txt"),
            "-results", os.path.join(save_dir, "results.txt")]
    c0 = clock.seconds if clock else 0.0
    t0 = time.perf_counter()
    lines = _run_cli(argv, "[Gerbicz Li] Check passed")
    wall = time.perf_counter() - t0
    comp = (clock.seconds if clock else 0.0) - c0
    it = int(_find(lines, r"Check passed! iter=(\d+)").group(1))
    saved_at = int(_find(lines, r"state saved at iteration (\d+)").group(1))
    if saved_at != it:
        raise AssertionError(f"saved at {saved_at}, GL check at {it}")
    if os.path.exists(os.path.join(save_dir, "results.txt")):
        raise AssertionError("an interrupted run wrote a result")
    # the first check replays one GL block of B squarings
    squarings = it + math.isqrt(p)
    log("prp", f"smoke: first GL check passed at iteration {it}; "
               f"{squarings} squarings incl. the GL replay in {wall:.2f} s "
               f"(compile {comp:.2f} s) = {squarings / (wall - comp):.1f} "
               f"iter/s excluding compile (smoke, not a benchmark)")

    path = ck.ckpt_filename(p, "prp", False, save_dir)
    saved = ck.load_latest(path, p, ck.MODE_TAGS["prp"])
    if saved is None or saved.iteration != it:
        raise AssertionError(f"checkpoint {path} missing or not at {it}")
    plan = cached_plan(p)
    r0 = np.frombuffer(saved.regs[:plan.n * 8], dtype=np.uint64)
    x_it = dg.digits_to_int(r0, plan.widths)
    log("prp", f"checkpoint {os.path.basename(path)} written at "
               f"iteration {saved.iteration}")

    # resume; stop at the res64 display RESUME_STEPS squarings later
    stop = it + RESUME_STEPS
    lines = _run_cli(argv + ["-res64_display_interval", str(stop)],
                     "Res64:")
    _find(lines, r"Resuming from a checkpoint")
    hit = _find(lines, r"Iter: (\d+)\| Res64: ([0-9A-F]{16})")
    ref = reference_engine(p, 1)
    ref.set_int(0, x_it)
    ref.square_mul_seq(0, [1] * RESUME_STEPS)
    want = f"{ref.get_int(0) & 0xFFFFFFFFFFFFFFFF:016X}"
    if int(hit.group(1)) != stop or hit.group(2) != want:
        raise AssertionError(f"resumed run: iteration {hit.group(1)} "
                             f"res64 {hit.group(2)}, expected {stop} {want}")
    log("prp", f"resumed at {it}, res64 at {stop} = {want} matches "
               f"{type(ref).__name__}")


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

M100003_RES2048 = (
    "af262d00ed00a05d53e99d0e0e451b12405ddabe139fe8396a4c520b505bb65b"
    "ed1609d3c8ef23bbb1d0f8140a6bcdd2c67f9c8aa3bd0e6eeb3e8e79db904810"
    "c88de09820557176b389290f84f18424efa6a59fb9f132a74f53a83ba6e2f508"
    "c617a5e1451c3ee08d179e6614026f973d1900602f2068a08894cd81ed5035de"
    "9ded85909b1ee6ff4dc723118b79d3f940272ae1066aebe27c86338ad7edf70e"
    "76c0e8abf3e985b73db2a06f1b742a9a908728be2bd4b7daa2d6aafc11bacaaa"
    "40944e9a66b039cb0deaaa8e5e357cd54b81b3ec6661d55e48bacb994bfd3cbb"
    "33f3f01d82347fa00578ec86c4cd7eb568a1463cf3e38dae1cf45e9503c71fd6")


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def golden_prp_m9941(d, lines):
    from prmers_tpu.io.options import Options
    from prmers_tpu.modes.prp_ll import run_prp_or_ll
    r = run_prp_or_ll(Options(exponent=9941, mode="prp", proof=False,
                              save_dir=d), log=lines.append)
    _check(r.is_prime, "M9941 not reported prime")
    return "prime"


def golden_prp_m100003(d, lines):
    from prmers_tpu.io.options import Options
    from prmers_tpu.modes.prp_ll import run_prp_or_ll
    r = run_prp_or_ll(Options(exponent=100003, mode="prp", proof=False,
                              save_dir=d), log=lines.append)
    _check(not r.is_prime and r.res64 == "1CF45E9503C71FD6",
           f"M100003 res64 {r.res64}")
    _check(r.res2048.lower() == M100003_RES2048, "M100003 res2048")
    return f"res64 {r.res64}, res2048 matches"


def golden_ll_m127(d, lines):
    from prmers_tpu.io.options import Options
    from prmers_tpu.modes.prp_ll import run_prp_or_ll
    r = run_prp_or_ll(Options(exponent=127, mode="ll", proof=False,
                              save_dir=d), log=lines.append)
    _check(r.is_prime, "LL M127 not prime")
    return "prime"


def golden_pm1_m367(d, lines):
    from prmers_tpu.io.options import Options
    from prmers_tpu.modes.pm1 import run_pm1
    r = run_pm1(Options(exponent=367, mode="pm1", b1=11981, b2=38971,
                        stage2_variant="vtrace", save_dir=d),
                log=lines.append)
    _check(r.factor == 50500996776315830904406967 and r.stage == 2,
           f"P-1 M367 factor {r.factor} stage {r.stage}")
    return f"stage-2 factor {r.factor}"


def golden_ecm_m701(d, lines):
    from prmers_tpu.io.options import Options
    from prmers_tpu.modes.ecm_edwards import run_ecm_edwards
    r = run_ecm_edwards(Options(exponent=701, mode="ecm", b1=6000, b2=33333,
                                curves=8, curve_seed=1, save_dir=d),
                        log=lines.append)
    _check(any("batched" in str(m) for m in lines), "ECM did not batch")
    _check(r.factor == 68453816366333403527, f"ECM M701 factor {r.factor}")
    return f"factor {r.factor} (curves batched)"


def golden_prp_m9941_fft3161(d, lines):
    from prmers_tpu.io.options import Options
    from prmers_tpu.modes.prp_ll import run_prp_or_ll
    r = run_prp_or_ll(Options(exponent=9941, mode="prp", arith="fft3161",
                              proof=False, save_dir=d), log=lines.append)
    _check(any("Engine3161" in str(m) for m in lines), "not on Engine3161")
    _check(r.is_prime, "M9941 (fft3161) not reported prime")
    return "prime on Engine3161"


GOLDENS = {
    "prp M9941": golden_prp_m9941,
    "prp M100003": golden_prp_m100003,
    "ll M127": golden_ll_m127,
    "pm1 M367": golden_pm1_m367,
    "ecm M701": golden_ecm_m701,
    "prp M9941 fft3161": golden_prp_m9941_fft3161,
}


def phase_goldens(names=None) -> None:
    for name in names or GOLDENS:
        lines: list = []
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            detail = GOLDENS[name](d, lines)
        log("goldens", f"{name}: {detail} ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def four_chain(e, x: int) -> None:
    e.set_int(0, x)
    e.set_int(1, 3)
    e.square_mul(0)
    e.square_mul(0, 3)                  # fast-3 step
    e.square_mul(0)
    e.set_multiplicand(2, 1)
    e.mul(0, 2)
    e.sub(0, 2)                         # linear op over the carry ring


def phase_four(p: int, n_devices: int = 4) -> None:
    import numpy as np
    import jax
    from prmers_tpu.engine.jax_engine import JaxEngine
    from prmers_tpu.parallel.sharded import (ShardedEngine, make_mesh,
                                             psum_res64)

    rnd = random.Random(SEED)
    x = rnd.randrange((1 << p) - 1)
    mesh = make_mesh(n_devices)
    t0 = time.perf_counter()
    sh = ShardedEngine(p, 8, mesh)
    four_chain(sh, x)
    sh.sync()
    log("four", f"ShardedEngine p={p} n={sh.get_size()} over "
                f"{n_devices} devices ('limb' axis): chain "
                f"{time.perf_counter() - t0:.2f} s incl. tables + compile")
    t0 = time.perf_counter()
    one = JaxEngine(p, 8, device=jax.devices()[0])
    four_chain(one, x)
    one.sync()
    log("four", f"JaxEngine on one device: chain "
                f"{time.perf_counter() - t0:.2f} s incl. tables + compile")
    got, want = sh.get_digits(0), one.get_digits(0)
    if not np.array_equal(got, want):
        raise AssertionError(f"sharded vs one card: {_mismatch(got, want)}")
    r64 = int(psum_res64(sh.tables, sh.regs[0]))
    if r64 != one.get_int(0) & 0xFFFFFFFFFFFFFFFF:
        raise AssertionError("psum_res64 disagrees with the one-card res64")
    log("four", f"sharded result bit-exact with one card; psum_res64 "
                f"{r64:016X}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU ShardedEngine path")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = phase_device(4 if args.four else 1)
    clock = CompileClock()
    if args.four:
        phase_four(P_FLAGSHIP)
    else:
        phase_width(P_FLAGSHIP, clock)
        with tempfile.TemporaryDirectory() as d:
            phase_prp(P_FLAGSHIP, d, clock)
        phase_goldens()
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s "
                f"(XLA compile {clock.seconds:.1f} s)")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
