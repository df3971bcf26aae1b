"""Carry propagation over variable-width IBDWT digits.

The convolution output digits y_j are exact integers < P; normalization emits
the low width[j] bits of (y_j * a + carry_in) and forwards the rest. The carry
out of the last digit wraps to digit 0 (2^p == 1 mod M_p), which performs the
mod-M_p fold (reference behavior: kernels/marin.cl:1696-2414 two-phase
carry-weight kernels; here reformulated as vectorized carry-injection rounds —
each round shifts the carry array by one digit — followed by a
carry-lookahead scan, the whole-array equivalent of workgroup-scan + block
wrap).

Constraint: the small multiplier a must satisfy a < 2^16 so all intermediates
fit u64 (every call site uses a in {1, 3, ...small}).
"""

from __future__ import annotations

from ..core.field import FieldOps


def split(F: FieldOps, y, widths, masks):
    return y >> widths, y & masks


def carry_full(F: FieldOps, y, widths, masks, a, lax=None):
    """Exact normalization of digit vector y (values < P), optional small
    mul a: returns digits d with d[j] < 2^width[j] and value ==
    (sum y_j 2^(q_j)) * a mod M_p. `a` may be a python int or a traced
    u64 scalar. masks may be None (compact-table mode): derived
    transiently from widths, which may then be a narrow dtype (u8) to
    save HBM at huge n."""
    xp = F.xp
    if masks is None:
        widths = widths.astype(xp.uint64)
        masks = (xp.uint64(1) << widths) - xp.uint64(1)
    c, d = split(F, y, widths, masks)
    # fold in the small multiplier before propagation (adc_mul decomposition:
    # d*a < 2^(w+16), c*a < 2^(63-w+16) both fit u64 for a < 2^16)
    is_one = isinstance(a, int) and a == 1
    if not is_one:
        a64 = xp.uint64(a) if isinstance(a, int) else a
        t = d * a64
        c = c * a64 + (t >> widths)
        d = t & masks

    def inject(c, d):
        c = xp.roll(c, 1)
        t = d + c
        return t >> widths, t & masks

    if lax is None:
        # numpy host path
        import numpy as np
        while bool((c != 0).any()):
            c, d = inject(c, d)
        return d

    # Device path: looping `inject` until every carry is zero moves a
    # carry one digit per round, so a SATURATED DIGIT RUN (e.g. the
    # all-ones digits of masks - y after subtracting a small value, or a
    # register holding M_p - a) would ripple a 1 across up to all n
    # digits: ~n sequential full-vector rounds. Same cure as the mesh
    # carry (parallel/sharded.py _carry_local): a bounded absorb phase
    # shrinks carries geometrically to 0/1 (a saturated run only ever
    # FORWARDS a 1, it cannot grow one), then one generate/propagate
    # associative_scan resolves the 0/1 ripple in O(log n) with the
    # cyclic wrap (the mod-M_p fold) closed by feeding the total G
    # back into digit 0.
    def cond(state):
        return xp.any(state[0] > xp.uint64(1))

    def body(state):
        return inject(*state)

    # absorb: bounded by ~64/min(width) rounds regardless of data
    c, d = inject(c, d)
    c, d = lax.while_loop(cond, body, (c, d))

    # 0/1 ripple via carry-lookahead
    s = d + xp.roll(c, 1)              # s <= mask + 1 = 2^width
    g = s > masks                      # generates an out-carry
    p = s == masks                     # propagates an in-carry

    def compose(a, b):                 # a = earlier digits, b = later
        ga, pa = a
        gb, pb = b
        return gb | (pb & ga), pb & pa

    G, P = lax.associative_scan(compose, (g, p))
    x0 = G[-1]                         # cyclic fixed point (total G)
    xg, xp_ = xp.roll(G, 1), xp.roll(P, 1)
    first = lax.iota(xp.int32, d.shape[0]) == 0
    cin = xp.where(first, x0, xg | (xp_ & x0))
    return (s + cin.astype(xp.uint64)) & masks
