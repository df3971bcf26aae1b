"""Weighted NTT (IBDWT) over the Goldilocks field — matrix formulation.

The length-n transform is a four-step matrix NTT: a column pass of length R
(lane-parallel over C columns), factored mid-twiddles, a transpose, and a
column pass of length C. Stage outputs are left in DIF digit-reversed order
and consumed by the mirrored DIT inverse; only the fully-carried digit vector
is canonical, so internal ordering is free (unlike the reference's dispatch
tables, reference: include/marin/engine_gpu.h:1568-1630, the column passes
are batched array ops and, when sharded, the transposes are all-to-alls).

All functions are generic over the array namespace (numpy for the host oracle
engine, jax.numpy for the device engine).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..core import field
from ..core.field import P, FieldOps
from ..core.plan import Plan

I4 = field.root_nth(4)          # primitive 4th root of unity
I4_INV = field.inv(I4)
W5 = field.root_nth(5)          # primitive 5th root
W5_INV = field.inv(W5)


@dataclasses.dataclass
class StageT:
    radix: int
    tw: Any       # (radix, m) twiddles in target namespace
    tw_inv: Any


def _register_pytrees():
    """Register table containers as JAX pytrees so jitted ops can take them as
    arguments (shared compilation across engine instances)."""
    try:
        from jax import tree_util
    except ImportError:  # numpy-only usage
        return

    def stage_flatten(s):
        return (s.tw, s.tw_inv), s.radix

    def stage_unflatten(radix, children):
        return StageT(radix, *children)

    def tables_flatten(t):
        children = (t.stages_r, t.stages_c, t.mid_t1, t.mid_t2,
                    t.mid_t1_inv, t.mid_t2_inv, t.weights, t.inv_weights_n,
                    t.widths, t.masks)
        aux = (t.p, t.n, t.R, t.C, t.mid_tile, t.carry_rounds)
        return children, aux

    def tables_unflatten(aux, children):
        (stages_r, stages_c, mid_t1, mid_t2, mid_t1i, mid_t2i,
         weights, inv_weights_n, widths, masks) = children
        p, n, R, C, mid_tile, carry_rounds = aux
        return NttTables(
            p=p, n=n, R=R, C=C, stages_r=stages_r, stages_c=stages_c,
            mid_t1=mid_t1, mid_t2=mid_t2, mid_t1_inv=mid_t1i,
            mid_t2_inv=mid_t2i, mid_tile=mid_tile, weights=weights,
            inv_weights_n=inv_weights_n, widths=widths, masks=masks,
            carry_rounds=carry_rounds)

    tree_util.register_pytree_node(StageT, stage_flatten, stage_unflatten)
    tree_util.register_pytree_node(NttTables, tables_flatten, tables_unflatten)


def pow_by_exponents(F: FieldOps, base: int, e, max_bits: int):
    """Vectorized base^e[j] mod P for a u64 exponent array (bit decomposition)."""
    xp = F.xp
    out = xp.ones(e.shape, dtype=xp.uint64)
    sq = base % P
    for b in range(max(max_bits, 1)):
        bit = ((e >> xp.uint64(b)) & xp.uint64(1)) != 0
        out = xp.where(bit, F.mul(out, xp.uint64(sq)), out)
        sq = (sq * sq) % P
    return out


def powers_matrix(F: FieldOps, base_vec, count: int):
    """T[i, j] = base_vec[i]^j for j in [0, count) via column doubling."""
    xp = F.xp
    T = xp.ones((base_vec.shape[0], 1), dtype=xp.uint64)
    cur = base_vec
    while T.shape[1] < count:
        T = xp.concatenate([T, F.mul(T, cur[:, None])], axis=1)
        cur = F.mul(cur, cur)
    return T[:, :count]


def build_stages(F: FieldOps, radixes, length: int) -> list[StageT]:
    """Per-stage DIF twiddle tables tw[rdx, t] = omega_L^(rdx*t)."""
    xp = F.xp
    stages = []
    L = length
    for r in radixes:
        m = L // r
        w = field.root_nth(L)
        wi = field.inv(w)
        base = xp.asarray(np.array([pow(w, rdx, P) for rdx in range(r)],
                                   dtype=np.uint64))
        basei = xp.asarray(np.array([pow(wi, rdx, P) for rdx in range(r)],
                                    dtype=np.uint64))
        stages.append(StageT(r, powers_matrix(F, base, m),
                             powers_matrix(F, basei, m)))
        L = m
    return stages


@dataclasses.dataclass
class NttTables:
    """All transform tables, generated in a target array namespace.

    For the JAX engine the generation ops run on device, so even the n-element
    weight tables for a 2^23 transform build in milliseconds.
    """
    p: int
    n: int
    R: int
    C: int
    stages_r: list[StageT]
    stages_c: list[StageT]
    mid_t1: Any
    mid_t2: Any
    mid_t1_inv: Any
    mid_t2_inv: Any
    mid_tile: int
    weights: Any        # (n,) u64
    inv_weights_n: Any  # (n,) u64, inverse weights with 1/n folded in
    widths: Any         # (n,) u64 digit widths
    masks: Any          # (n,) u64 = 2^width - 1
    carry_rounds: int   # static carry-injection rounds before the fixup loop

    @classmethod
    def from_plan(cls, plan: Plan, xp, device_put=None, widths_arg=None,
                  compact_widths=False):
        """widths_arg: pass the (n,) u64 widths as a traced argument when
        building under jit — embedded as a constant it blows the remote
        compiler's program-size limit at n ~ 1e8 (HTTP 413)."""
        put = device_put if device_put is not None else (lambda a: xp.asarray(a))
        F = FieldOps(xp)
        p, n, R, C = plan.p, plan.n, plan.R, plan.C
        nbits = n.bit_length()

        # ---- DWT weights: weight[j] = nr2^((-(p%n)*j) mod n) -------------
        nr2 = field.root_two_nth(n)
        nr2i = field.inv(nr2)
        j = xp.arange(n, dtype=xp.int64)
        e = ((-(p % n) * j) % n).astype(xp.uint64)  # |.| < 2^52 exact
        weights = pow_by_exponents(F, nr2, e, nbits)
        inv_w = pow_by_exponents(F, nr2i, e, nbits)
        inv_weights_n = F.mul(inv_w, xp.uint64(plan.inv_n))

        # ---- stage twiddles ----------------------------------------------
        stages_r = build_stages(F, plan.radixes_r, R)
        stages_c = build_stages(F, plan.radixes_c, C)

        # ---- factored mid twiddles (row-permuted by the DIF ordering) ----
        # element (i, j) of the (R, C) matrix after the first column pass
        # holds frequency f = freq_r[i] and needs omega_n^(f*j), factored as
        # omega^(f*TILE*(j//TILE)) * omega^(f*(j%TILE)).
        tile = min(128, C)
        jhi = C // tile
        wn = field.root_nth(n)
        wni = field.inv(wn)
        freq = xp.asarray(plan.freq_r).astype(xp.uint64)
        base = pow_by_exponents(F, wn, freq, R.bit_length())
        basei = pow_by_exponents(F, wni, freq, R.bit_length())
        mid_t2 = powers_matrix(F, base, tile)
        mid_t2i = powers_matrix(F, basei, tile)
        base_t = F.pow_const(base, tile)
        base_ti = F.pow_const(basei, tile)
        mid_t1 = powers_matrix(F, base_t, jhi)
        mid_t1i = powers_matrix(F, base_ti, jhi)

        widths64 = widths_arg if widths_arg is not None else \
            put(plan.widths.astype(np.uint64))
        if compact_widths:
            # widths as u8 and NO materialized masks: at n ~ 1e8 the two
            # u64 tables would cost 2.6 GB of always-resident HBM; the
            # carry derives masks transiently instead
            widths64 = widths64.astype(xp.uint8)
            masks = None
        else:
            masks = (xp.uint64(1) << widths64) - xp.uint64(1)

        # number of carry rounds until the residual carry is provably <= 1:
        # after round k the carry is < 2^(63 - k*w_min) (plus 1); see carry().
        wmin = int(plan.widths.min())
        rounds = 1
        bound = plan.max_word * 9  # allow for the small multiplier a
        while bound >> (rounds * wmin) > 1:
            rounds += 1
        return cls(
            p=p, n=n, R=R, C=C,
            stages_r=[StageT(s.radix, put(s.tw), put(s.tw_inv))
                      for s in stages_r],
            stages_c=[StageT(s.radix, put(s.tw), put(s.tw_inv))
                      for s in stages_c],
            mid_t1=put(mid_t1), mid_t2=put(mid_t2),
            mid_t1_inv=put(mid_t1i), mid_t2_inv=put(mid_t2i),
            mid_tile=tile,
            weights=put(weights),
            inv_weights_n=put(inv_weights_n),
            widths=widths64,
            masks=put(masks) if masks is not None else None,
            carry_rounds=rounds,
        )


# ---------------------------------------------------------------------------
# Column transforms (along axis 0), DIF forward / DIT inverse
# ---------------------------------------------------------------------------

def _butterfly_fwd(F: FieldOps, parts, radix):
    if radix == 2:
        a0, a1 = parts
        return [F.add(a0, a1), F.sub(a0, a1)]
    if radix == 4:
        a0, a1, a2, a3 = parts
        b0 = F.add(a0, a2)
        b1 = F.sub(a0, a2)
        b2 = F.add(a1, a3)
        b3 = F.mul_scalar(F.sub(a1, a3), I4)
        return [F.add(b0, b2), F.add(b1, b3), F.sub(b0, b2), F.sub(b1, b3)]
    if radix == 5:
        return _dft5(F, parts, W5)
    raise ValueError(radix)


def _butterfly_inv(F: FieldOps, parts, radix):
    if radix == 2:
        a0, a1 = parts
        return [F.add(a0, a1), F.sub(a0, a1)]
    if radix == 4:
        z0, z1, z2, z3 = parts
        b0 = F.add(z0, z2)
        b1 = F.sub(z0, z2)
        b2 = F.add(z1, z3)
        b3 = F.mul_scalar(F.sub(z1, z3), I4_INV)
        return [F.add(b0, b2), F.add(b1, b3), F.sub(b0, b2), F.sub(b1, b3)]
    if radix == 5:
        return _dft5(F, parts, W5_INV)
    raise ValueError(radix)


def _dft5(F: FieldOps, parts, w5):
    out = []
    for r in range(5):
        acc = parts[0]
        for s in range(1, 5):
            term = F.mul_scalar(parts[s], pow(w5, r * s, P))
            acc = F.add(acc, term)
        out.append(acc)
    return out


def col_fwd(F: FieldOps, x, stages):
    """DIF column transform along axis 0 of x (shape (L, lanes...))."""
    xp = F.xp
    lanes = x.shape[1:]
    B = 1
    L = x.shape[0]
    for st in stages:
        r = st.radix
        m = L // r
        v = x.reshape((B, r, m) + lanes)
        parts = [v[:, s] for s in range(r)]
        outs = _butterfly_fwd(F, parts, r)
        # twiddle rows 1..r-1 (row 0 is all-ones)
        tw = st.tw.reshape((1, r, m) + (1,) * len(lanes))
        outs = [outs[0]] + [F.mul(outs[i], tw[:, i]) for i in range(1, r)]
        x = xp.stack(outs, axis=1).reshape((B * r, m) + lanes)
        B *= r
        L = m
    return x.reshape((B * L,) + lanes)


def col_inv(F: FieldOps, x, stages):
    """DIT column inverse along axis 0, consuming col_fwd's ordering."""
    xp = F.xp
    lanes = x.shape[1:]
    total = x.shape[0]
    # reconstruct (B, r, m) shapes in reverse stage order
    dims = []
    L = total
    for st in stages:
        r = st.radix
        dims.append((L, r))
        L //= r
    for st, (Lcur, r) in zip(reversed(stages), reversed(dims)):
        m = Lcur // r
        B = total // Lcur
        v = x.reshape((B, r, m) + lanes)
        twi = st.tw_inv.reshape((1, r, m) + (1,) * len(lanes))
        parts = [v[:, 0]] + [F.mul(v[:, i], twi[:, i]) for i in range(1, r)]
        outs = _butterfly_inv(F, parts, r)
        x = xp.stack(outs, axis=1).reshape((B * Lcur,) + lanes)
    return x


# ---------------------------------------------------------------------------
# Full weighted transform
# ---------------------------------------------------------------------------

def _mid_twiddle(F: FieldOps, x, t1, t2, R, C, tile):
    """Multiply (R, C) matrix by factored mid twiddles omega^(freq(i)*j)."""
    jhi = C // tile
    v = x.reshape(R, jhi, tile)
    v = F.mul(v, t1[:, :, None])
    v = F.mul(v, t2[:, None, :])
    return v.reshape(R, C)


_register_pytrees()


def forward(F: FieldOps, t: NttTables, x):
    """Digits (n,) -> spectral representation (C, R) (scrambled both axes)."""
    x = F.mul(x, t.weights)
    x = x.reshape(t.R, t.C)
    x = col_fwd(F, x, t.stages_r)
    x = _mid_twiddle(F, x, t.mid_t1, t.mid_t2, t.R, t.C, t.mid_tile)
    x = x.T  # (C, R)
    x = col_fwd(F, x, t.stages_c)
    return x


def inverse(F: FieldOps, t: NttTables, z):
    """Spectral (C, R) -> unnormalized convolution digits (n,) (pre-carry)."""
    x = col_inv(F, z, t.stages_c)
    x = x.T  # (R, C)
    x = _mid_twiddle(F, x, t.mid_t1_inv, t.mid_t2_inv, t.R, t.C, t.mid_tile)
    x = col_inv(F, x, t.stages_r)
    x = x.reshape(t.n)
    return F.mul(x, t.inv_weights_n)
