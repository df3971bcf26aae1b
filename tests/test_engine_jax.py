import random

import numpy as np
import pytest

from prmers_tpu.engine.jax_engine import JaxEngine
from prmers_tpu.engine.np_engine import NumpyEngine


@pytest.mark.parametrize("p", [127, 1279])
def test_jax_matches_python(p):
    eng = JaxEngine(p, 3)
    mp = (1 << p) - 1
    rnd = random.Random(p)
    v = rnd.randrange(1, mp)
    eng.set_int(0, v)
    assert eng.get_int(0) == v
    for a in [1, 3, 1]:
        eng.square_mul(0, a)
        v = v * v * a % mp
        assert eng.get_int(0) == v


def test_jax_seq_and_ops(p=521):
    eng = JaxEngine(p, 4)
    mp = (1 << p) - 1
    rnd = random.Random(7)
    x, y = rnd.randrange(mp), rnd.randrange(mp)
    eng.set_int(0, x)
    eng.set_int(1, y)
    # seq with mixed multipliers crossing the chunk boundary
    eng._SEQ_CHUNK = 8
    a_vec = [rnd.choice([1, 1, 3]) for _ in range(21)]
    eng.square_mul_seq(0, a_vec)
    for a in a_vec:
        x = x * x * a % mp
    assert eng.get_int(0) == x

    eng.set_multiplicand(2, 1)
    eng.mul(0, 2, 3)
    x = x * y * 3 % mp
    assert eng.get_int(0) == x

    eng.add(0, 1); x = (x + y) % mp
    assert eng.get_int(0) == x
    eng.sub_reg(0, 1); x = (x - y) % mp
    assert eng.get_int(0) == x
    eng.sub(0, 2); x = (x - 2) % mp
    assert eng.get_int(0) == x
    eng.addsub(2, 3, 0, 1)
    assert eng.get_int(2) == (x + y) % mp
    assert eng.get_int(3) == (x - y) % mp


def test_jax_matches_numpy_digits(p=127):
    """Digit vectors (not just values) must agree between backends."""
    e1, e2 = JaxEngine(p, 1), NumpyEngine(p, 1)
    e1.set_int(0, 3)
    e2.set_int(0, 3)
    for _ in range(30):
        e1.square_mul(0, 3)
        e2.square_mul(0, 3)
    assert (e1.get_digits(0) == e2.get_digits(0)).all()


def test_checkpoint_roundtrip_jax(p=127):
    eng = JaxEngine(p, 2)
    eng.set_int(0, 11111)
    eng.set_multiplicand(1, 0)
    data = eng.get_checkpoint()
    eng2 = JaxEngine(p, 2)
    eng2.set_checkpoint(data)
    assert eng2.get_int(0) == 11111
    assert (eng2.get_raw(1) == eng.get_raw(1)).all()


class TestRowEngine:
    """Row-mode variant (huge-n path, forced small here)."""

    def test_matches_slab_engine(self):
        from prmers_tpu.engine.jax_engine import JaxEngine, JaxRowEngine
        p = 1279
        mp = (1 << p) - 1
        a = JaxEngine(p, 4)
        b = JaxRowEngine(p, 4)
        for e in (a, b):
            e.set(0, 3)
            e.square_mul_seq(0, [1, 3, 1])
            e.set_int(1, 424242)
            e.set_multiplicand(2, 1)
            e.copy(3, 0)
            e.mul(3, 2, 7)
            e.addsub(1, 2, 3, 0)
            e.sub(1, 5)
        for i in (0, 1, 3):
            assert a.get_int(i) == b.get_int(i), i

    def test_copy_alias_safety(self):
        from prmers_tpu.engine.jax_engine import JaxRowEngine
        p = 521
        e = JaxRowEngine(p, 3)
        e.set_int(0, 999)
        e.copy(1, 0)
        e.square_mul(1, 1)      # must not disturb reg 0
        assert e.get_int(0) == 999


class TestCompactWidths:
    def test_carry_full_derives_masks(self):
        import numpy as np
        from prmers_tpu.core.field import FieldOps
        from prmers_tpu.ops import carry as carry_ops
        from prmers_tpu.core.plan import build_plan
        F = FieldOps(np)
        plan = build_plan(1279)
        rng = np.random.default_rng(0)
        y = rng.integers(0, 1 << 40, plan.n, dtype=np.uint64)
        w64 = plan.widths.astype(np.uint64)
        masks = (np.uint64(1) << w64) - np.uint64(1)
        full = carry_ops.carry_full(F, y.copy(), w64, masks, 3)
        compact = carry_ops.carry_full(F, y.copy(),
                                       plan.widths.astype(np.uint8), None, 3)
        assert np.array_equal(full, compact)


class TestSaturatedRipple:
    """The device carry_full must resolve a saturated-digit ripple in
    O(log n), not O(n) ring rounds: a while-until-zero form walks a 1
    across every digit of e.g. masks - small (sub of a small value),
    one full-vector round per digit."""

    def _lax_vs_np(self, y, widths):
        import jax
        import jax.numpy as jnp
        from prmers_tpu.core.field import FieldOps
        from prmers_tpu.ops import carry as carry_ops
        Fj = FieldOps(jnp)
        Fn = FieldOps(np)
        w64 = widths.astype(np.uint64)
        masks = (np.uint64(1) << w64) - np.uint64(1)
        want = carry_ops.carry_full(Fn, y.copy(), w64, masks.copy(), 1)
        got = jax.jit(lambda yy, ww: carry_ops.carry_full(
            Fj, yy, ww, None, 1, lax=jax.lax))(y, widths.astype(np.uint8))
        assert np.array_equal(np.asarray(got), want)

    def test_allones_single_carry(self):
        # all-saturated digits + one carry: the full-ring ripple case
        n = 4096
        widths = np.full(n, 5, np.uint8)
        widths[1::7] = 6
        masks = (1 << widths.astype(np.uint64)) - 1
        y = masks.copy()
        y[0] += 1
        self._lax_vs_np(y, widths)

    def test_mp_representation_fixed_point(self):
        # value M_p (all mask, no carries) must stay put, not ripple
        n = 512
        widths = np.full(n, 6, np.uint8)
        masks = (1 << widths.astype(np.uint64)) - 1
        y = masks.copy()
        self._lax_vs_np(y, widths)

    def test_random_with_mul(self):
        import jax
        import jax.numpy as jnp
        from prmers_tpu.core.field import FieldOps
        from prmers_tpu.ops import carry as carry_ops
        Fj = FieldOps(jnp)
        Fn = FieldOps(np)
        n = 2048
        rng = np.random.default_rng(3)
        widths = np.where(rng.random(n) < 0.5, 5, 6).astype(np.uint8)
        w64 = widths.astype(np.uint64)
        masks = (np.uint64(1) << w64) - np.uint64(1)
        y = rng.integers(0, 1 << 60, n, dtype=np.uint64)
        want = carry_ops.carry_full(Fn, y.copy(), w64, masks.copy(), 3)
        got = jax.jit(lambda yy, ww: carry_ops.carry_full(
            Fj, yy, ww, None, 3, lax=jax.lax))(y, widths)
        assert np.array_equal(np.asarray(got), want)


def test_checkpoint_live_multiplicand(p=127):
    """A checkpoint taken with a prepared multiplicand must restore to an
    engine where mul against that register still works (VERDICT round-1
    weak #4: the spectral flag must survive the round trip)."""
    mp = (1 << p) - 1
    eng = JaxEngine(p, 3)
    eng.set_int(0, 12345)
    eng.set_int(1, 6789)
    eng.set_multiplicand(2, 1)
    blob = eng.get_checkpoint()
    eng2 = JaxEngine(p, 3)
    eng2.set_checkpoint(blob)
    eng2.mul(0, 2)
    assert eng2.get_int(0) == 12345 * 6789 % mp


def test_checkpoint_live_multiplicand_3161(p=521):
    from prmers_tpu.engine.engine3161 import Engine3161
    mp = (1 << p) - 1
    eng = Engine3161(p, 3)
    eng.set_int(0, 98765)
    eng.set_int(1, 43210)
    eng.set_multiplicand(2, 1)
    blob = eng.get_checkpoint()
    eng2 = Engine3161(p, 3)
    eng2.set_checkpoint(blob)
    eng2.mul(0, 2)
    assert eng2.get_int(0) == 98765 * 43210 % mp


def test_checkpoint_legacy_format(p=127):
    """Old-format blobs (no flag block) still restore as digit registers."""
    eng = JaxEngine(p, 2)
    eng.set_int(0, 777)
    eng.set_int(1, 888)
    legacy = b"".join(eng.get_raw(r).tobytes() for r in range(2))
    eng2 = JaxEngine(p, 2)
    eng2.set_checkpoint(legacy)
    assert eng2.get_int(0) == 777 and eng2.get_int(1) == 888
