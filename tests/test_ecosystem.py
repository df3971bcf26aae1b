"""CLI, worktodo, result JSON, app dispatcher, and web GUI tests."""

import json
import os
import urllib.request

import pytest

from prmers_tpu.core.app import run_app, run_once
from prmers_tpu.io.cli import parse_args
from prmers_tpu.io.json_out import build_result_json
from prmers_tpu.io.worktodo import Worktodo, parse_line


class TestCli:
    def test_prp_default(self):
        o = parse_args(["9941", "-backend", "numpy"])
        assert o.exponent == 9941 and o.mode == "prp"

    def test_pm1_flags(self):
        o = parse_args(["367", "-pm1", "-b1", "11981", "-b2", "38971"])
        assert o.mode == "pm1" and o.b1 == 11981 and o.b2 == 38971

    def test_factors(self):
        o = parse_args(["2699", "-prp", "-factors", "5399,307687"])
        assert o.known_factors == ("5399", "307687")

    def test_config_expansion(self, tmp_path):
        cfg = tmp_path / "c.cfg"
        cfg.write_text("-pm1 -b1 100\n")
        o = parse_args(["541", "-config", str(cfg)])
        assert o.mode == "pm1" and o.b1 == 100

    def test_reference_flag_aliases(self):
        """Reference CLI spellings must parse to the same options
        (reference: include/io/CliParser.hpp:11-145)."""
        o = parse_args(["367", "-pm1", "-b1", "100", "-b2", "2000",
                        "-pm1-lowmem", "-pm1-vtrace-max-regs", "64",
                        "-s2from", "500"])
        assert o.pm1_variant == "lowmem"
        assert o.stage2_regs_cap == 64 and o.b2_start == 500
        o = parse_args(["367", "-pm1", "-b1", "9", "-b2", "99",
                        "-pm1-stage2-classic", "-nogcd-stage1"])
        assert o.stage2_variant == "classic" and o.no_gcd_stage1
        o = parse_args(["2053", "-ecm", "-torsion16", "-seed", "7",
                        "-ecm-continue-after-factor"])
        assert o.torsion == 16 and o.curve_seed == 7
        assert o.continue_after_factor
        o = parse_args(["2053", "-ecm", "-iv163"])
        assert o.torsion == 163
        o = parse_args(["127", "-llunsafe"])
        assert o.mode == "ll"

    def test_pfa_and_resume2reg_aliases(self):
        """PFA plan flags force the second arithmetic path; the
        resume2reg spellings imply ultralowmem + stage-2-only resume
        (reference: CliParser.cpp:277-330, :613-621)."""
        for flag in ("-pfa3", "-pfa9", "-pfa9-type4", "-pfa9-type4-full",
                     "-pfa9-fft323161", "-pfa=9"):
            assert parse_args(["9941", flag]).arith == "fft3161", flag
        assert parse_args(["9941", "-pfa-off"]).arith == "gl64"
        assert parse_args(["9941", "-no-pfa"]).arith == "gl64"
        assert parse_args(["9941", "-pfa"]).arith == "auto"
        o = parse_args(["9941", "-aevum-fft", "pfa9:4:512:9:512:202"])
        assert o.arith == "fft3161"
        o = parse_args(["367", "-pm1", "-b1", "100", "-b2", "2000",
                        "-pm1-s2-resume2reg"])
        assert o.pm1_variant == "ultralowmem" and o.s2_resume
        o = parse_args(["367", "-pm1", "-b1", "100", "-pm1-1reg"])
        assert o.pm1_variant == "ultralowmem" and not o.s2_resume
        o = parse_args(["9941", "-user", "u", "-password", "pw"])
        assert o.password == "pw"

    def test_noop_reference_flags_accepted(self, capsys):
        """Flags with no meaning here parse without error and note the
        no-op (kernelpath/local sizes/network submission etc.)."""
        o = parse_args(["9941", "-backend", "numpy", "-gerbiczli",
                        "-proof", "-kernelpath", "/tmp/k", "-l1", "64",
                        "-submit", "-vtrace-pair95",
                        "-pm1-vtrace-product-tree-width", "8"])
        assert o.exponent == 9941 and o.gerbiczli and o.proof
        err = capsys.readouterr().err
        assert "-kernelpath" in err and "no-op" in err

    def test_gui_host_flags(self):
        """-http <port> / -host / -ipv4 (reference GUI options)."""
        o = parse_args(["9941", "-gui", "-http", "8080"])
        assert o.gui and o.gui_port == 8080
        assert o.gui_host == "127.0.0.1"      # safe default bind
        o = parse_args(["9941", "-gui", "-host", "10.0.0.5"])
        assert o.gui_host == "10.0.0.5"
        o = parse_args(["9941", "-gui", "-ipv4"])
        assert o.gui_host == "0.0.0.0"

    def test_memlim_budget(self, monkeypatch):
        import os
        from prmers_tpu.engine.paged import device_reg_budget
        monkeypatch.delenv("PRMERS_MAX_DEVICE_REGS", raising=False)
        monkeypatch.setenv("PRMERS_MEMLIM_MB", "512")
        small = device_reg_budget(1 << 20)
        monkeypatch.delenv("PRMERS_MEMLIM_MB")
        big = device_reg_budget(1 << 20)
        assert 2 <= small < big


class TestExponentRange:
    def test_out_of_range_rejected(self):
        """Exponents beyond the largest transform are rejected cleanly
        (reference: unit_tests.sh:91-107 out-of-range rejection)."""
        import pytest
        from prmers_tpu.core.app import run_once, MAX_EXPONENT
        from prmers_tpu.io.options import Options
        from prmers_tpu.core.plan import transform_size
        assert transform_size(MAX_EXPONENT) > 0   # boundary is exact
        with pytest.raises(SystemExit):
            run_once(Options(exponent=MAX_EXPONENT + 1, mode="prp"),
                     log=lambda *a, **k: None)


class TestWorktodo:
    def test_parse_prp_with_aid(self):
        e = parse_line("PRP=ABCDEF0123456789ABCDEF0123456789,1,2,9941,-1")
        assert e.mode == "prp" and e.exponent == 9941
        assert e.aid == "ABCDEF0123456789ABCDEF0123456789"

    def test_parse_pm1(self):
        e = parse_line("Pminus1=1,2,367,-1,11981,38971")
        assert e.mode == "pm1" and e.b1 == 11981 and e.b2 == 38971

    def test_parse_pfactor(self):
        """PFactor= lines are P-1 entries (WorktodoParser.cpp:164-203)."""
        from prmers_tpu.io.worktodo import parse_line
        e = parse_line('PFactor=1,2,1362763,-1,29,6910159,'
                       '"46333943,282345414919"')
        assert e.mode == "pm1" and e.exponent == 1362763
        assert e.b1 == 29 and e.b2 == 6910159
        assert e.known_factors == ("46333943", "282345414919")

    def test_parse_pfactor_primenet_shape(self):
        """Canonical PrimeNet PFactor lines carry (sieve_depth,
        has_been_pminus1ed), not bounds — they must get wavefront-scale
        auto bounds, not a trivially useless B1=76 run."""
        from prmers_tpu.io.worktodo import parse_line
        e = parse_line('PFactor=N/A,1,2,104729,-1,76,1')
        assert e.mode == "pm1" and e.exponent == 104729
        assert e.b1 >= 50000 and e.b2 == 30 * e.b1
        assert e.sieve_depth == 76.0

    def test_parse_known_factors(self):
        e = parse_line('PRP=1,2,2699,-1,99,0,"5399,307687"')
        assert e.known_factors == ("5399", "307687")

    def test_parse_test_ll(self):
        e = parse_line("Test=44497,74,1")
        assert e.mode == "ll" and e.exponent == 44497

    def test_remove_first(self, tmp_path):
        wt_path = tmp_path / "worktodo.txt"
        wt_path.write_text("# comment\nPRP=1,2,127,-1\nPRP=1,2,521,-1\n")
        wt = Worktodo(str(wt_path))
        assert wt.first_entry().exponent == 127
        assert wt.remove_first_processed()
        assert wt.first_entry().exponent == 521
        assert (tmp_path / "worktodo_save.txt").read_text().strip() == \
            "PRP=1,2,127,-1"


class TestJson:
    def test_prp_fields(self):
        j = json.loads(build_result_json(
            exponent=9941, worktype="PRP-3", status="P",
            res64="0000000000000001", res2048="01", fft_length=512,
            timestamp="2026-01-01 00:00:00"))
        assert j["status"] == "P" and j["worktype"] == "PRP-3"
        assert j["checksum"]["version"] == 1
        assert len(j["checksum"]["checksum"]) == 8

    def test_checksum_deterministic(self):
        a = build_result_json(exponent=1, worktype="LL", status="C",
                              res64="AB", timestamp="t")
        b = build_result_json(exponent=1, worktype="LL", status="C",
                              res64="AB", timestamp="t")
        assert a == b


class TestApp:
    def test_worktodo_batch(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        (tmp_path / "worktodo.txt").write_text(
            "PRP=1,2,1279,-1\nPminus1=1,2,541,-1,899,0\n")
        o = parse_args(["-backend", "numpy", "-noproof", "-q"])
        code = run_app(o, log=lambda *a: None)
        assert code == 0
        assert (tmp_path / "1279_prp_result.json").exists()
        assert (tmp_path / "541_pm1_result.json").exists()
        results = (tmp_path / "results.txt").read_text().strip().splitlines()
        assert len(results) == 2
        assert json.loads(results[1])["factors"] == ["4312790327"]
        assert (tmp_path / "worktodo.txt").read_text().strip() == ""

    def test_single_run_exit_codes(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        o = parse_args(["1279", "-backend", "numpy", "-noproof", "-q"])
        assert run_app(o, log=lambda *a: None) == 0   # prime
        o = parse_args(["1windows", "-q"]) if False else \
            parse_args(["929", "-ll", "-backend", "numpy", "-q"])
        assert run_app(o, log=lambda *a: None) == 1   # composite

    def test_proof_via_app(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        o = parse_args(["1279", "-backend", "numpy", "-proofpower", "2",
                        "-proofverify", "-q"])
        lines = []
        assert run_app(o, log=lines.append) == 0
        assert any("Verification result: SUCCESS" in l for l in lines)
        assert (tmp_path / "m1279-2.proof").exists()


class TestGui:
    def test_endpoints(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        from prmers_tpu.ui.webgui import WebGui
        o = parse_args(["-gui-port", "3977", "-q"])
        g = WebGui(o)
        g.start()
        try:
            g.set_state(status="running", exponent=127)
            st = json.loads(urllib.request.urlopen(
                "http://localhost:3977/api/state", timeout=5).read())
            assert st["status"] == "running" and st["exponent"] == 127
            req = urllib.request.Request(
                "http://localhost:3977/api/append-worktodo",
                data=b"PRP=1,2,127,-1", method="POST")
            urllib.request.urlopen(req, timeout=5)
            body = urllib.request.urlopen(
                "http://localhost:3977/api/load-worktodo",
                timeout=5).read().decode()
            assert "PRP=1,2,127,-1" in body
        finally:
            g.stop()


class TestProfileAndLogTee:
    def test_profile_report(self, tmp_path, monkeypatch):
        """-profile prints a per-op table after the run (reference:
        per-kernel profile map behind -profile, include/marin/ocl.h:238)."""
        monkeypatch.chdir(tmp_path)
        lines = []
        o = parse_args(["521", "-backend", "numpy", "-noproof", "-q",
                        "-profile"])
        run_app(o, log=lambda *a: lines.append(" ".join(map(str, a))))
        prof = [ln for ln in lines if ln.startswith("[profile]")]
        assert any("square_mul" in ln for ln in prof)
        assert any("ms/op" in ln for ln in prof)

    def test_log_tee(self, tmp_path, monkeypatch):
        """main() tees all log lines to prmers.log (reference:
        src/main.cpp:34-90 TeeBuf)."""
        monkeypatch.chdir(tmp_path)
        from prmers_tpu.core.app import main
        code = main(["521", "-backend", "numpy", "-noproof", "-q"])
        assert code == 0
        text = (tmp_path / "prmers.log").read_text()
        assert "521" in text and "res64" in text.lower()
