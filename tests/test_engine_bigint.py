"""JaxEngine against Python big-int arithmetic mod M_p, at power-of-two and
5*2^k transform shapes: edge values, a pending wrap carry, fast-3 chains,
multiplicands, the LL step and addsub. Plus the device carry on saturated
digit runs against the host carry and the big-int value."""

import random

import numpy as np
import pytest

from prmers_tpu.core.plan import cached_plan
from prmers_tpu.engine.jax_engine import JaxEngine

# n = 64, 512 (2^k) and n = 80, 5120 (5*2^k)
SHAPES = [1279, 9941, 2203, 110503]


@pytest.fixture(params=SHAPES, ids=lambda p: f"M{p}")
def eng(request):
    p = request.param
    e = JaxEngine(p, 4)
    n = e.get_size()
    assert n & (n - 1) == 0 or (n % 5 == 0 and (n // 5) & (n // 5 - 1) == 0)
    return e


def _mp(e):
    return (1 << e.p) - 1


def test_edge_values(eng):
    mp = _mp(eng)
    eng.set_int(0, 0)
    eng.square_mul(0)
    assert eng.get_int(0) == 0
    eng.set_int(1, mp - 1)
    eng.square_mul(1, 3)                 # (-1)^2 * 3
    assert eng.get_int(1) == 3
    eng.set_int(2, mp - 1)
    eng.set_multiplicand(3, 2)
    eng.mul(2, 3)                        # (-1) * (-1)
    assert eng.get_int(2) == 1
    eng.set_int(2, mp - 1)
    eng.add_small(2, 1)                  # wraps to 0 (== M_p)
    assert eng.get_int(2) == 0


def test_pending_wrap_carry(eng):
    """States next to M_p push a carry out of the top digit, which must
    wrap into digit 0 (2^p == 1 mod M_p)."""
    mp = _mp(eng)
    eng.set_int(0, mp - 5)
    eng.square_mul(0)
    assert eng.get_int(0) == 25
    eng.set_int(1, mp - 2)
    eng.add_small(1, 7)
    assert eng.get_int(1) == 5
    top = 1 << (eng.p - 1)               # top bit set: doubling wraps
    eng.set_int(2, top + 1)
    eng.set_int(3, top + 1)
    eng.add(2, 3)
    assert eng.get_int(2) == (2 * (top + 1)) % mp


def test_fast3_chain(eng):
    mp = _mp(eng)
    rnd = random.Random(eng.p)
    x = rnd.randrange(mp)
    eng.set_int(0, x)
    eng._SEQ_CHUNK = 8                   # the chain crosses chunk edges
    a_vec = [rnd.choice((1, 3)) for _ in range(19)]
    eng.square_mul_seq(0, a_vec)
    for a in a_vec:
        x = x * x * a % mp
    assert eng.get_int(0) == x


def test_multiplicand_mul(eng):
    mp = _mp(eng)
    rnd = random.Random(eng.p + 1)
    x, y = rnd.randrange(mp), rnd.randrange(mp)
    eng.set_int(0, x)
    eng.set_int(1, y)
    eng.set_multiplicand(2, 1)
    eng.mul(0, 2, 3)
    assert eng.get_int(0) == x * y * 3 % mp
    eng.mul(0, 2)
    assert eng.get_int(0) == x * y * y * 3 % mp
    assert eng.get_int(1) == y           # the source stays digits


def test_square_sub2_seq(eng):
    mp = _mp(eng)
    x = 4
    eng.set_int(0, x)
    eng.square_sub2_seq(0, 7)
    for _ in range(7):
        x = (x * x - 2) % mp
    assert eng.get_int(0) == x


def test_addsub(eng):
    mp = _mp(eng)
    rnd = random.Random(eng.p + 2)
    x, y = rnd.randrange(mp), rnd.randrange(mp)
    eng.set_int(0, x)
    eng.set_int(1, y)
    eng.addsub(2, 3, 0, 1)
    assert eng.get_int(2) == (x + y) % mp
    assert eng.get_int(3) == (x - y) % mp
    eng.addsub(2, 3, 1, 0)               # negative difference
    assert eng.get_int(3) == (y - x) % mp
    eng.sub_reg(0, 0)                    # x - x is 0 (or M_p)
    assert eng.get_int(0) == 0


# ---------------------------------------------------------------------------
# carry_full on saturated digit runs
# ---------------------------------------------------------------------------

def _value(d, widths, p):
    from prmers_tpu.utils import digits as dg
    return dg.digits_to_int(np.asarray(d, dtype=np.uint64), widths) % \
        ((1 << p) - 1)


def _saturated(kind: str, widths):
    masks = (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1)
    n = widths.size
    y = masks.copy()
    if kind == "all_plus_one":           # ripple around the whole ring
        y[0] += np.uint64(1)
    elif kind == "mid_run":              # saturated run fed at its start
        y[:] = 0
        y[n // 4:3 * n // 4] = masks[n // 4:3 * n // 4]
        y[n // 4] += np.uint64(1)
    elif kind == "tail_run_wraps":       # run ending at the top digit
        y[: n // 2] = 0
        y[n // 2] += np.uint64(1)
    elif kind == "mp_fixed_point":       # M_p itself: no carry at all
        pass
    elif kind == "one_gap":              # the ripple stops at one digit
        y[n // 3] = 0
        y[0] += np.uint64(1)
    elif kind == "big_carries":          # multi-bit carries everywhere
        y = y << np.uint64(20)
    return y


@pytest.mark.parametrize("kind", ["all_plus_one", "mid_run",
                                  "tail_run_wraps", "mp_fixed_point",
                                  "one_gap", "big_carries"])
@pytest.mark.parametrize("a", [1, 3])
def test_carry_full_saturated(kind, a):
    import jax
    import jax.numpy as jnp
    from prmers_tpu.core.field import FieldOps
    from prmers_tpu.ops import carry as carry_ops
    p = 9941
    plan = cached_plan(p)
    w64 = plan.widths.astype(np.uint64)
    masks = (np.uint64(1) << w64) - np.uint64(1)
    y = _saturated(kind, plan.widths)
    want = carry_ops.carry_full(FieldOps(np), y.copy(), w64, masks, a)
    got = jax.jit(lambda yy: carry_ops.carry_full(
        FieldOps(jnp), yy, jnp.asarray(w64), jnp.asarray(masks), a,
        lax=jax.lax))(jnp.asarray(y))
    got = np.asarray(got)
    assert np.array_equal(got, want)
    assert (got <= masks).all()
    assert _value(got, plan.widths, p) == \
        _value(y, plan.widths, p) * a % ((1 << p) - 1)
