"""Application dispatcher — ties CLI/worktodo entries to mode drivers,
result JSON, proofs, and worktodo bookkeeping.

Analog of the reference App (reference: src/core/App.cpp:254-460 config
merge + workload classification, :863-1095 run() dispatch). Where the
reference execs itself between worktodo entries (restart_self,
AlgoUtils.hpp:126), this loops in-process.
"""

from __future__ import annotations

import os

from ..engine.factory import configure_backend
from ..io import json_out
from ..io.options import Options
from ..io.worktodo import (Worktodo, append_results_txt,
                           write_individual_json)


def _merge_worktodo(opts: Options, entry) -> Options:
    opts.exponent = entry.exponent
    opts.mode = entry.mode
    opts.aid = entry.aid or opts.aid
    if entry.known_factors:
        opts.known_factors = entry.known_factors
    if entry.b1:
        opts.b1 = entry.b1
    if entry.b2:
        opts.b2 = entry.b2
    if entry.b2_start:
        opts.b2_start = entry.b2_start
    if entry.curves:
        opts.curves = entry.curves
    return opts


def _log_arith_decision(opts: Options, log, gui=None) -> None:
    """Backend-decision telemetry (reference: setBackendInfo card,
    src/core/App.cpp:900-920 / WebGuiServer /api/state)."""
    if opts.exponent <= 0 or opts.mode in ("bench", "tune", "memtest"):
        return
    try:
        from ..engine.policy import decide_arith
        wl = {"prp": "prp", "ll": "ll", "llsafe": "ll", "llsafe2": "ll",
              "pm1": "pm1_s1", "ecm": "ecm"}.get(opts.mode, "generic")
        d = decide_arith(opts.exponent, wl, opts.save_dir) \
            if opts.arith == "auto" else None
        arith = opts.arith if opts.arith != "auto" else d.arith
        reason = "forced by -arith" if opts.arith != "auto" else d.reason
        n = d.n_3161 if (d and arith == "fft3161") else (
            d.n_gl64 if d else 0)
        log(f"Arithmetic path: {arith} ({reason})" +
            (f" | n_gl64={d.n_gl64} n_3161={d.n_3161} "
             f"ratio={d.ratio:.2f}" if d else ""))
        if gui is not None:
            gui.set_backend_info(arith, n, reason)
    except Exception:   # telemetry must never block a run
        pass


# Largest exponent any plan family carries: the 5*2^26 Goldilocks shape
# at 16 bits/word (reference analog: the ~5.65e9 cap, unit_tests.sh:91-107)
MAX_EXPONENT = 17 * (5 << 26) - 1


def run_once(opts: Options, log=print, gui=None) -> tuple[object, str]:
    """Run one workload; returns (result, json_line)."""
    if opts.save_dir:
        # every artifact (ckpts, proofs, result JSON, prmers.log) lands
        # here; a fresh directory must not abort mid-run
        os.makedirs(opts.save_dir, exist_ok=True)
    if opts.exponent > MAX_EXPONENT and opts.arith != "fft3161":
        # forced fft3161 may exceed this (its 3-smooth capacity table
        # extends further); the default gl64 families cannot
        raise SystemExit(
            f"Exponent {opts.exponent} out of range: the largest "
            f"supported transform (5*2^26) caps at {MAX_EXPONENT}")
    configure_backend(opts.backend)
    from .profile import report_all, set_profiling
    set_profiling(bool(getattr(opts, "profile", False)))
    _log_arith_decision(opts, log, gui)
    try:
        return _run_once_inner(opts, log, gui)
    finally:
        if getattr(opts, "profile", False):
            report_all(log)
            set_profiling(False)


def _run_once_inner(opts: Options, log=print, gui=None):
    if opts.mode in ("prp", "ll"):
        from ..modes.prp_ll import run_prp_or_ll
        proof_set = None
        proof = None
        if (opts.mode == "prp" and opts.proof and not opts.wagstaff
                and opts.exponent > 128):
            from .proof import ProofSet, best_power
            from .plan import cached_plan
            power = opts.proof_power or best_power(opts.exponent)
            proof_set = ProofSet(opts.exponent, power,
                                 widths=cached_plan(opts.exponent).widths,
                                 save_dir=opts.save_dir,
                                 known_factors=opts.known_factors)
        r = run_prp_or_ll(opts, proof_set=proof_set, log=log)
        if r.interrupted:
            return r, ""        # state is checkpointed; no result yet
        proof_md5 = ""
        proof_power = 0
        if proof_set is not None and not r.interrupted and not r.quick:
            try:
                proof = proof_set.compute_proof(log=log)
                path = proof.save(proof.filename(opts.save_dir))
                log(f"proof written to {path}")
                proof_power = proof.power
                import hashlib
                with open(path, "rb") as f:
                    proof_md5 = hashlib.md5(f.read()).hexdigest()
                if opts.proof_verify:
                    proof.verify(log=log)
            except (OSError, RuntimeError, ValueError) as e:
                log(f"proof generation failed: {e}")
        if opts.mode == "prp" and opts.known_factors:
            status = "PRP" if r.cofactor_prp else "C"
        else:
            status = "P" if r.is_prime else "C"
        if opts.wagstaff:
            status = "PRP" if r.wagstaff_prp else "C"
        j = json_out.build_result_json(
            exponent=opts.exponent,
            worktype="PRP-3" if opts.mode == "prp" else "LL",
            status=status, res64=r.res64.upper(),
            res2048=r.res2048.upper(),
            gerbicz_errors=r.gerbicz_errors,
            fft_length=r.transform_size,
            known_factors=opts.known_factors,
            proof_power=proof_power, proof_md5=proof_md5,
            user=opts.user, computer=opts.computer, aid=opts.aid)
        return r, j
    if opts.mode in ("llsafe", "llsafe2"):
        if opts.mode == "llsafe2":
            from ..modes.llsafe import run_llsafe2 as run_llsafe
        else:
            from ..modes.llsafe import run_llsafe
        r = run_llsafe(opts, log=log)
        j = json_out.build_result_json(
            exponent=opts.exponent, worktype="LL",
            status="P" if r.is_prime else "C", res64=r.res64.upper(),
            gerbicz_errors=r.gerbicz_errors, fft_length=r.transform_size,
            user=opts.user, computer=opts.computer, aid=opts.aid)
        return r, j
    if opts.mode == "pm1":
        from ..modes.pm1 import run_pm1
        r = run_pm1(opts, log=log)
        factors = (str(r.factor),) if r.factor else ()
        j = json_out.build_result_json(
            exponent=opts.exponent, worktype="PM1",
            status="F" if r.factor else "NF",
            b1=opts.b1, b2=opts.b2, factors=factors,
            gerbicz_errors=r.gerbicz_errors,
            fft_length=r.transform_size,
            user=opts.user, computer=opts.computer, aid=opts.aid)
        return r, j
    if opts.mode == "ecm":
        # twisted Edwards is the default ECM path, Montgomery the fallback
        # (reference: App::run dispatches runECMMarinTwistedEdwards unless
        # -ecm_montgomery, src/core/App.cpp)
        if getattr(opts, "edwards", True):
            from ..modes.ecm_edwards import run_ecm_edwards as run_ecm
        else:
            from ..modes.ecm import run_ecm
        r = run_ecm(opts, log=log)
        factors = (str(r.factor),) if r.factor else ()
        j = json_out.build_result_json(
            exponent=opts.exponent, worktype="ECM",
            status="F" if r.factor else "NF",
            b1=opts.b1, b2=opts.b2, factors=factors,
            curves=r.curves, curve_seed=opts.curve_seed,
            edwards=False, torsion=opts.torsion, sigma=opts.sigma,
            user=opts.user, computer=opts.computer, aid=opts.aid)
        return r, j
    if opts.mode == "bench":
        from ..modes.bench import run_bench
        r = run_bench(opts, log=log)
        return r, ""
    if opts.mode == "memtest":
        from ..modes.memtest import run_memtest
        r = run_memtest(opts, log=log)
        return r, ""
    if opts.mode == "tune":
        from .tune import run_tune
        r = run_tune(opts, log=log)
        return r, ""
    raise ValueError(f"unknown mode {opts.mode!r}")


class LogTee:
    """Tees log lines to a prmers.log file next to the save dir while still
    printing them (reference: the TeeBuf stdout/stderr tee,
    src/main.cpp:34-90). Used as the `log` callable by run_app/main."""

    def __init__(self, path: str, inner=print):
        self.inner = inner
        self._f = None
        try:
            self._f = open(path, "a", buffering=1)
        except OSError:
            pass

    def __call__(self, *args, **kwargs):
        self.inner(*args, **kwargs)
        if self._f is not None:
            try:
                import time as _t
                stamp = _t.strftime("%Y-%m-%d %H:%M:%S")
                self._f.write(f"[{stamp}] " +
                              " ".join(str(a) for a in args) + "\n")
            except OSError:
                pass

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def run_app(opts: Options, log=print) -> int:
    """Top-level driver: worktodo loop or single run. Returns exit code
    (reference exit semantics: 0 = prime/PRP/factor found where
    applicable)."""
    if getattr(opts, "filemers", ""):
        # utility conversion mode: .mers checkpoint -> GMP-ECM .save
        # (reference: App::exportResumeFromMersFile, App.cpp:520-553)
        from ..io import interop
        try:
            out = interop.convert_mers_to_save(opts.filemers)
        except (OSError, ValueError) as e:
            log(f"-filemers failed: {e}")
            return 1
        log(f"GMP ECM file written to: {out}")
        return 0
    gui = None
    if opts.gui:
        from ..ui.webgui import WebGui
        gui = WebGui(opts)
        gui.start()
        log(f"web GUI on http://localhost:{opts.gui_port}")
    try:
        wt = Worktodo(opts.worktodo_path)
        entry = wt.first_entry()
        if entry is not None and opts.exponent == 0:
            exit_code = 0
            while entry is not None:
                _merge_worktodo(opts, entry)
                if gui:
                    gui.set_state(status="running", exponent=opts.exponent,
                                  mode=opts.mode)
                r, j = run_once(opts, log=log, gui=gui)
                if getattr(r, "interrupted", False):
                    return 1    # the entry stays queued for the resume
                if j:
                    append_results_txt(opts.results_path, j)
                    write_individual_json(opts.save_dir, opts.exponent,
                                          opts.mode, j)
                    log(j)
                wt.remove_first_processed()
                entry = wt.first_entry()
            return exit_code
        if opts.exponent == 0 and opts.mode not in ("bench", "tune",
                                                    "memtest"):
            log("nothing to do: no exponent and no worktodo entries")
            return 2
        r, j = run_once(opts, log=log, gui=gui)
        if j:
            append_results_txt(opts.results_path, j)
            write_individual_json(opts.save_dir, opts.exponent, opts.mode, j)
            log(j)
        if opts.mode in ("bench", "tune", "memtest"):
            errs = getattr(r, "errors", 0) + getattr(r, "roundtrip_errors", 0)
            return 0 if not errs else 1
        is_prime = bool(getattr(r, "is_prime", False) or
                        getattr(r, "factor", 0) or
                        getattr(r, "wagstaff_prp", False) or
                        getattr(r, "cofactor_prp", False))
        return 0 if is_prime else 1
    finally:
        if gui:
            gui.stop()


def main(argv=None) -> int:
    from ..io.cli import parse_args
    from ..parallel import dist
    dist.init_from_env()   # join a multi-process group if configured
    opts = parse_args(argv)
    log = LogTee(os.path.join(opts.save_dir, "prmers.log"))
    try:
        return run_app(opts, log=log)
    finally:
        log.close()
