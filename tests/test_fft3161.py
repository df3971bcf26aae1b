"""Second arithmetic path: GF(M31^2) x GF(M61^2) NTT, engine, policy."""

import numpy as np
import pytest

from prmers_tpu.core.field2 import (F31, F61, M31, M61, Fq2Ops, crt_pair)
from prmers_tpu.engine.engine3161 import Engine3161
from prmers_tpu.engine.policy import decide_arith
from prmers_tpu.io.options import Options
from prmers_tpu.ops import ntt2
from prmers_tpu.utils import digits as dg


class TestField2:
    def test_roots(self):
        for F in (F31, F61):
            for n in (8, 1024, 3 * 64, 9 * 32):
                assert F.pow(F.root_two(n), n) == (2, 0)
                assert F.order_is(F.root_unity(n), n)

    def test_crt(self):
        rng = np.random.default_rng(1)
        for _ in range(50):
            v = int(rng.integers(0, 1 << 62)) << 29 | int(
                rng.integers(0, 1 << 29))
            assert crt_pair(v % M31, v % M61) == v

    def test_vector_mul_edges(self):
        for q, s, F in ((M31, 31, F31), (M61, 61, F61)):
            ops = Fq2Ops(np, q, s)
            edges = np.array([0, 1, 2, q - 1, q - 2, q // 2],
                             dtype=np.uint64)
            for a in edges:
                for b in edges:
                    got = int(ops.mulq(np.array([a]), np.array([b]))[0])
                    assert got == int(a) * int(b) % q


class TestTransform:
    @pytest.mark.parametrize("p,n", [(4423, None), (1279, 3 * 64),
                                     (11213, 9 * 64)])
    def test_square_chain(self, p, n):
        t = ntt2.build_tables(p, n, np)
        ops31 = Fq2Ops(np, M31, 31)
        ops61 = Fq2Ops(np, M61, 61)
        wid32 = np.asarray(t.widths).astype(np.uint32)
        mp = (1 << p) - 1
        rng = np.random.default_rng(7)
        v = int.from_bytes(rng.bytes(p // 8), "little") % mp
        d = dg.int_to_digits(v, wid32)
        want = v
        for a in (1, 3, 1):
            s31, s61 = ntt2.forward_3161(ops31, ops61, t, d)
            lo, hi = ntt2.inverse_3161(ops31, ops61, t, ops31.sqr(s31),
                                       ops61.sqr(s61))
            d = ntt2.carry_3161(np, lo, hi, t.widths, t.masks, a)
            want = want * want * a % mp
        assert dg.digits_to_int(d, wid32) % mp == want

    def test_transform_size_model(self):
        # fft3161 sizes must be ~half the Goldilocks size (the CRT
        # capacity win) and support the 3*2^k families
        from prmers_tpu.core.plan import transform_size
        for p in (9941, 136279841, 57885161):
            n2 = ntt2.transform_size_3161(p)
            ngl = transform_size(p)
            assert n2 <= ngl
            w = p // n2
            assert 2 * (w + 1) + np.log2(n2) < 92

    def test_bpw_capacity_table(self):
        """Per-shape BPW capacity model (fftbpw analog): the shape table
        is sorted, capacities are exact boundaries (p = max_exponent
        selects a shape <= n; p over the boundary violates the
        convolution bound for n), and transform_size agrees with the
        table everywhere."""
        rows = ntt2.shape_table_3161(22)
        ns = [r[0] for r in rows]
        assert ns == sorted(ns) and len(set(ns)) == len(ns)
        for n, bpw, pmax in rows:
            assert bpw == ntt2.max_bpw_3161(n)
            assert pmax == ntt2.max_exponent_3161(n)
            # boundary is exact w.r.t. the convolution capacity rule
            assert 2 * (pmax // n + 1) + np.log2(n) < ntt2.LOG2_CRT
            assert not (2 * ((pmax + n) // n + 1) + np.log2(n)
                        < ntt2.LOG2_CRT)
        for n, _bpw, pmax in rows[3:12]:
            assert ntt2.transform_size_3161(pmax) <= n
            bigger = ntt2.transform_size_3161(pmax + 1)
            assert bigger > pmax // (ntt2.max_bpw_3161(bigger) + 1)


class TestEngine3161:
    @pytest.mark.heavy  # smoke budget: numpy-oracle PRP is the slow twin
    def test_prp_m1279_numpy(self):
        from prmers_tpu.modes.prp_ll import run_prp_or_ll
        o = Options(exponent=1279, mode="prp", backend="numpy",
                    arith="fft3161", proof=False)
        r = run_prp_or_ll(o, log=lambda *a: None)
        assert r.is_prime

    def test_mul_and_gl_ops(self):
        p = 2203
        mp = (1 << p) - 1
        eng = Engine3161(p, 6, xp=np)
        eng.set_int(0, 123456789)
        eng.set_multiplicand(1, 0)
        eng.set_int(2, 987654321)
        eng.mul(2, 1, 5)
        assert eng.get_int(2) == 123456789 * 987654321 * 5 % mp
        eng.set_int(3, 10)
        eng.set_int(4, 3)
        eng.addsub(5, 3, 3, 4)  # sum, diff outputs
        assert eng.get_int(5) == 13
        assert eng.get_int(3) == 7

    def test_jax_engine_matches_numpy(self):
        import jax.numpy as jnp
        p = 1279
        mp = (1 << p) - 1
        en = Engine3161(p, 2, xp=np)
        ej = Engine3161(p, 2, xp=jnp)
        for e in (en, ej):
            e.set(0, 3)
            e.square_mul_seq(0, [1, 3, 1, 3, 1])
        assert en.get_int(0) == ej.get_int(0)


class TestPolicy:
    def test_ratio_and_defaults(self, tmp_path):
        # flagship with no tune records: gl64 holds
        d = decide_arith(136279841, "prp", str(tmp_path))
        assert d.arith == "gl64"
        assert d.ratio <= 1.0
        assert d.n_3161 < d.n_gl64

    def test_measured_smaller_transform_wins(self, tmp_path):
        """The reference's core decision rule (AutoPolicy.cpp:86-152)
        realized through measured rates: when the fft3161 family measures
        faster and its transform ratio is within the workload threshold,
        the second path is picked."""
        from prmers_tpu.core import tune
        p = 756839
        d0 = decide_arith(p, "prp", str(tmp_path))
        tune.record(d0.n_gl64, "JaxEngine", 100.0, str(tmp_path))
        tune.record(d0.n_3161, "Engine3161", 140.0, str(tmp_path))
        d = decide_arith(p, "prp", str(tmp_path))
        assert d.arith == "fft3161"

    def test_unmeasured_never_picks_fft3161(self, tmp_path):
        """With NO fft3161 measurement anywhere the bare ratio rule never
        fires: its premise (comparable per-word rates) is measured false
        for the XLA stand-in. gl64 holds until -tune provides rates."""
        for p in (9941, 756839, 136279841):
            d = decide_arith(p, "prp", str(tmp_path))
            assert d.arith == "gl64"
            assert "tune" in d.reason or "gl64" in d.reason

    def test_workload_threshold_boundary(self, tmp_path, monkeypatch):
        """Policy boundary at the exact per-workload ratio threshold
        (reference: the plan-policy boundary tests, README.md:903-921):
        with measured rates favoring fft3161, the env override pinning
        the threshold just below/above the actual ratio must flip the
        decision."""
        from prmers_tpu.core import tune
        p = 756839
        d0 = decide_arith(p, "pm1_s1", str(tmp_path))
        tune.record(d0.n_gl64, "JaxEngine", 100.0, str(tmp_path))
        tune.record(d0.n_3161 * 2, "Engine3161", 80.0, str(tmp_path))
        r = d0.ratio
        monkeypatch.setenv("PRMERS_AUTO_PM1_S1_MAX_RATIO",
                           str(r - 0.001))
        d = decide_arith(p, "pm1_s1", str(tmp_path))
        assert d.arith == "gl64"          # ratio now exceeds threshold
        monkeypatch.setenv("PRMERS_AUTO_PM1_S1_MAX_RATIO",
                           str(r + 0.001))
        d = decide_arith(p, "pm1_s1", str(tmp_path))
        assert d.arith == "fft3161", d

    def test_reference_aevum_env_spellings(self, tmp_path, monkeypatch):
        """The reference's AEVUM_AUTO_* env names steer the same policy
        (reference: CliParser.cpp help 'Auto policy env')."""
        from prmers_tpu.core import tune
        p = 756839
        d0 = decide_arith(p, "pm1_s1", str(tmp_path))
        tune.record(d0.n_gl64, "JaxEngine", 100.0, str(tmp_path))
        tune.record(d0.n_3161 * 2, "Engine3161", 80.0, str(tmp_path))
        r = d0.ratio
        monkeypatch.setenv("AEVUM_AUTO_PM1_STAGE1_MAX_RATIO",
                           str(r + 0.001))
        d = decide_arith(p, "pm1_s1", str(tmp_path))
        assert d.arith == "fft3161", d
        monkeypatch.delenv("AEVUM_AUTO_PM1_STAGE1_MAX_RATIO")
        monkeypatch.setenv("AEVUM_AUTO_MAX_RATIO", str(r - 0.001))
        d = decide_arith(p, "pm1_s1", str(tmp_path))
        assert d.arith == "gl64"

    def test_extrapolated_rates(self, tmp_path):
        """With tune data at OTHER sizes, rates extrapolate (n*log n) and
        decide instead of the bare ratio rule — a slow measured fft3161
        family is never picked at a new size."""
        from prmers_tpu.core import tune
        p = 136279841
        d0 = decide_arith(p, "prp", str(tmp_path))
        # gl64 fast at a nearby size, fft3161 slow at a nearby size
        tune.record(d0.n_gl64 // 2, "JaxEngine", 300.0, str(tmp_path))
        tune.record(d0.n_3161 // 2, "Engine3161", 10.0, str(tmp_path))
        d = decide_arith(p, "prp", str(tmp_path))
        assert d.arith == "gl64"
        assert "extrapolated" in d.reason
        # and a measured-faster fft3161 family wins within the threshold
        tune.record(d0.n_3161 // 2, "Engine3161", 2000.0, str(tmp_path))
        d = decide_arith(p, "prp", str(tmp_path))
        assert d.arith == "fft3161"

    def test_tune_data_overrides(self, tmp_path):
        from prmers_tpu.core import tune
        p = 136279841
        d0 = decide_arith(p, "prp", str(tmp_path))
        tune.record(d0.n_gl64, "JaxEngine", 100.0, str(tmp_path))
        tune.record(d0.n_3161, "Engine3161", 250.0, str(tmp_path))
        d = decide_arith(p, "prp", str(tmp_path))
        assert d.arith == "fft3161"
        tune.record(d0.n_gl64, "JaxEngine", 500.0, str(tmp_path))
        d = decide_arith(p, "prp", str(tmp_path))
        assert d.arith == "gl64"

    def test_env_force(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PRMERS_ARITH", "fft3161")
        d = decide_arith(9941, "prp", str(tmp_path))
        assert d.arith == "fft3161"
