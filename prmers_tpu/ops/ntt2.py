"""Paired GF(M31^2) x GF(M61^2) IBDWT NTT — the second arithmetic path.

Analog of the reference's Aevum "FFT3161" backend (reference:
third_party/aevum/src/FFTConfig.h:24 FFT3161 type, Gpu.cpp square pipeline
:2987-3035, math.cl GF31/GF61 arithmetic :618-640): the same integer
convolution is computed mod M31 and mod M61 in the quadratic extensions
(where 2^k- and 3^a-order roots exist), and the ~92-bit CRT combination
doubles the usable bits-per-word over Goldilocks — roughly half the
transform size for the same exponent.

v1 is the XLA/numpy correctness path (one full-length DIF column transform
per plane, generic radix-2/3/4 butterflies over (re, im) pairs).
Supported sizes:
n = 2^k, 3*2^k, 9*2^k.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np

from ..core import field2
from ..core.field2 import F31, F61, Fq2, Fq2Ops, M31, M61
from ..core.plan import digit_widths

LOG2_CRT = 91.99   # log2(M31 * M61), safely rounded down


def max_bpw_3161(n: int) -> int:
    """Per-shape capacity: the largest MEAN bits-per-word w = floor(p/n)
    the shape supports — the fftbpw analog of the reference
    (third_party/aevum FFTConfig.h:70-106 / fftbpw.h per-shape BPW
    tables). Exact-NTT version: the convolution bound
    2*(w+1) + log2 n < log2(M31*M61) with w+1 the max digit width
    (IBDWT ceil-split digits are at most one bit over the mean); no
    round-off-error tables are needed because the arithmetic is exact."""
    import math
    return int((LOG2_CRT - math.log2(n)) / 2 - 1)


def max_exponent_3161(n: int) -> int:
    """Largest exponent the shape n supports (capacity boundary)."""
    return n * (max_bpw_3161(n) + 1) - 1


def shape_table_3161(max_k: int = 27) -> list[tuple[int, int, int]]:
    """Sorted (n, max_bpw, max_exponent) rows for every supported shape
    n in {2^k, 3*2^k, 9*2^k}, n >= 8 — the inspectable per-shape plan
    table (reference: aevum FFT config enumeration, FFTConfig.h:24)."""
    rows = []
    for odd in (1, 3, 9):
        for k in range(1, max_k + 1):
            n = odd << k
            if n >= 8:
                rows.append((n, max_bpw_3161(n), max_exponent_3161(n)))
    rows.sort()
    return rows


def transform_size_3161(p: int) -> int:
    """Smallest n in {2^k, 3*2^k, 9*2^k} with p within the shape's BPW
    capacity (max_exponent_3161)."""
    for n, _bpw, pmax in shape_table_3161(40):
        if p <= pmax:
            return max(n, 8)
    raise ValueError("exponent too large")


def radix_seq_23(length: int) -> tuple[int, ...]:
    """DIF stage radices for n = 3^a * 2^k (a <= 2)."""
    seq = []
    L = length
    while L % 3 == 0:
        seq.append(3)
        L //= 3
    k = L.bit_length() - 1
    assert L == 1 << k, f"invalid 3161 length {length}"
    if k % 2 == 1:
        seq.append(2)
        k -= 1
    seq.extend([4] * (k // 2))
    return tuple(seq)


@dataclasses.dataclass
class PlaneTables:
    """Per-field tables (all arrays are (re, im) u64 pairs)."""
    q: int
    s: int
    stages: Any          # list of (radix, tw_pair (r, m), twi_pair)
    dmat: Any            # {r: ((r, r) pair, (r, r) inverse pair)}
    weights: Any         # (n,) pair
    unweights: Any       # (n,) pair, includes 1/n


@dataclasses.dataclass
class Tables3161:
    p: int
    n: int
    widths: Any          # (n,) u64
    masks: Any           # (n,) u64
    p31: PlaneTables
    p61: PlaneTables
    crt_minv: int        # q31^-1 mod q61


def _pairs(xp, vals):
    re = xp.asarray(np.array([v[0] for v in vals], dtype=np.uint64))
    im = xp.asarray(np.array([v[1] for v in vals], dtype=np.uint64))
    return re, im


def _build_plane(F: Fq2, xp, p: int, n: int) -> PlaneTables:
    radixes = radix_seq_23(n)
    # stage twiddles, mirroring ntt.build_stages: at stage (radix r over
    # length L), tw[s, j] = w_L^(s * j) for j < m = L/r
    stages = []
    L = n
    while L > 1:
        r = radixes[len(stages)]
        m = L // r
        wL = F.root_unity(L)
        rows = []
        for s in range(r):
            base = F.pow(wL, s)
            acc = (1, 0)
            row = []
            for _ in range(m):
                row.append(acc)
                acc = F.mul(acc, base)
            rows.append(row)
        tw = _pairs(xp, [v for row in rows for v in row])
        twi = _pairs(xp, [F.inv(v) for row in rows for v in row])
        stages.append((r, (tw[0].reshape(r, m), tw[1].reshape(r, m)),
                       (twi[0].reshape(r, m), twi[1].reshape(r, m))))
        L = m
    # small DFT matrices per radix
    dmat = {}
    for r in set(radixes):
        wr = F.root_unity(r)
        fwd = [F.pow(wr, (s * t) % r) for s in range(r) for t in range(r)]
        inv = [F.inv(v) for v in fwd]
        f = _pairs(xp, fwd)
        i = _pairs(xp, inv)
        dmat[r] = ((f[0].reshape(r, r), f[1].reshape(r, r)),
                   (i[0].reshape(r, r), i[1].reshape(r, r)))
    # IBDWT weights: w_j = r2^((n - (p*j mod n)) mod n), r2^n = 2
    r2 = F.root_two(n)
    r2i = F.inv(r2)
    ninv = F.inv((n % F.q, 0))
    ws = []
    uws = []
    for j in range(n):
        e = (n - (p * j) % n) % n
        ws.append(F.pow(r2, e))
        uws.append(F.mul(F.pow(r2i, e), ninv))
    return PlaneTables(q=F.q, s=F.s, stages=stages, dmat=dmat,
                       weights=_pairs(xp, ws), unweights=_pairs(xp, uws))


@functools.lru_cache(maxsize=4)
def _tables_np(p: int, n: int) -> "Tables3161":
    return build_tables(p, n, np)


def build_tables(p: int, n: int | None, xp) -> Tables3161:
    if n is None:
        n = transform_size_3161(p)
    widths = digit_widths(p, n)
    masks = (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1)
    return Tables3161(
        p=p, n=n,
        widths=xp.asarray(widths.astype(np.uint64)),
        masks=xp.asarray(masks),
        p31=_build_plane(F31, xp, p, n),
        p61=_build_plane(F61, xp, p, n),
        crt_minv=field2.Q31_INV_MOD_Q61,
    )


# ---------------------------------------------------------------------------
# Transforms (x is an (re, im) pair of (n,) u64 arrays)
# ---------------------------------------------------------------------------

def _apply_dft(ops: Fq2Ops, parts, mat):
    """outs[s] = sum_t mat[s, t] * parts[t] (r x r small DFT)."""
    r = len(parts)
    mre, mim = mat
    is_np = ops.xp is np  # the ones-shortcut needs concrete entries
    outs = []
    for s in range(r):
        acc = None
        for t in range(r):
            if is_np and (int(mre[s, t]), int(mim[s, t])) == (1, 0):
                term = parts[t]
            else:
                term = ops.mul((mre[s, t], mim[s, t]), parts[t])
            acc = term if acc is None else ops.add(acc, term)
        outs.append(acc)
    return outs


def _neg_pair(ops: Fq2Ops, x):
    zero = ops.xp.uint64(0) * x[0]
    return ops.subq(zero, x[0]), ops.subq(zero, x[1])


@functools.lru_cache(maxsize=None)
def _w4_is_i(q: int) -> bool:
    """Whether the consistent root family's w_4 is +i (else it is -i).
    The radix-4 butterfly needs the concrete unit at trace time; the
    dmat tables carry it only as traced arrays."""
    F = field2.F31 if q == field2.M31 else field2.F61
    w4 = F.root_unity(4)
    assert w4 in ((0, 1), (0, q - 1)), w4
    return w4 == (0, 1)


@functools.lru_cache(maxsize=None)
def _w3_pair(q: int, inverse: bool):
    """root_unity(3) (or its inverse) as concrete ints for the radix-3
    butterfly — same consistent root family as the dmat tables."""
    F = field2.F31 if q == field2.M31 else field2.F61
    w = F.root_unity(3)
    return F.inv(w) if inverse else w


def _bfly(ops: Fq2Ops, parts, inverse: bool):
    """Radix-2/3/4 DFT without the r x r general-multiply matrix.

    Radix 2/4: every matrix entry is a unit (1, -1, ±i) — adds/subs and
    mul_i only. Radix 3 (Winograd): with w^2 = -1 - w,
      out1 = (x0 - x2) + w(x1 - x2),  out2 = (x0 - x1) - w(x1 - x2),
    i.e. ONE general multiply. All bit-exact equal to _apply_dft with
    dmat (same root family); far smaller XLA graphs."""
    xp = ops.xp
    r = len(parts)
    if r == 2:
        x0, x1 = parts
        return [ops.add(x0, x1), ops.sub(x0, x1)]
    if r == 3:
        x0, x1, x2 = parts
        wr, wi = _w3_pair(ops.q, inverse)
        m = ops.mul((xp.uint64(wr), xp.uint64(wi)), ops.sub(x1, x2))
        out0 = ops.add(x0, ops.add(x1, x2))
        out1 = ops.add(ops.sub(x0, x2), m)
        out2 = ops.sub(ops.sub(x0, x1), m)
        return [out0, out1, out2]
    assert r == 4, r
    x0, x1, x2, x3 = parts
    a = ops.add(x0, x2)
    b = ops.sub(x0, x2)
    c = ops.add(x1, x3)
    d = ops.sub(x1, x3)
    wd = ops.mul_i(d)
    if _w4_is_i(ops.q) == inverse:      # w (fwd) vs w^-1 = -w (inv)
        wd = _neg_pair(ops, wd)
    return [ops.add(a, c), ops.add(b, wd), ops.sub(a, c), ops.sub(b, wd)]


def plane_fwd(ops: Fq2Ops, x, pt: PlaneTables):
    """DIF forward along the (n,) axis; output frequency-scrambled."""
    xp = ops.xp
    n = x[0].shape[0]
    B, L = 1, n
    re, im = x
    for (r, tw, _) in pt.stages:
        m = L // r
        vre = re.reshape(B, r, m)
        vim = im.reshape(B, r, m)
        parts = [(vre[:, t], vim[:, t]) for t in range(r)]
        if r in (2, 3, 4):
            outs = _bfly(ops, parts, inverse=False)
        else:
            outs = _apply_dft(ops, parts, pt.dmat[r][0])
        # twiddle output row s by tw[s] (row 0 is ones)
        tre, tim = tw
        outs = [outs[0]] + [
            ops.mul((tre[s][None, :], tim[s][None, :]), outs[s])
            for s in range(1, r)]
        re = xp.stack([o[0] for o in outs], axis=1).reshape(B * r, m)
        im = xp.stack([o[1] for o in outs], axis=1).reshape(B * r, m)
        B *= r
        L = m
    return re.reshape(n), im.reshape(n)


def plane_inv(ops: Fq2Ops, x, pt: PlaneTables):
    """DIT inverse consuming plane_fwd's ordering."""
    xp = ops.xp
    n = x[0].shape[0]
    re, im = x
    dims = []
    L = n
    for (r, _, _) in pt.stages:
        dims.append((L, r))
        L //= r
    for (r, _, twi), (Lcur, _) in zip(reversed(pt.stages), reversed(dims)):
        m = Lcur // r
        B = n // Lcur
        vre = re.reshape(B, r, m)
        vim = im.reshape(B, r, m)
        tre, tim = twi
        parts = [(vre[:, 0], vim[:, 0])] + [
            ops.mul((tre[s][None, :], tim[s][None, :]), (vre[:, s], vim[:, s]))
            for s in range(1, r)]
        if r in (2, 3, 4):
            outs = _bfly(ops, parts, inverse=True)
        else:
            outs = _apply_dft(ops, parts, pt.dmat[r][1])
        re = xp.stack([o[0] for o in outs], axis=1).reshape(B * r * m)
        im = xp.stack([o[1] for o in outs], axis=1).reshape(B * r * m)
    return re, im


def plane_square_spectral(ops: Fq2Ops, s):
    return ops.sqr(s)


def forward_3161(ops31: Fq2Ops, ops61: Fq2Ops, t: Tables3161, d):
    """Digits (n,) u64 -> spectral pairs ((re31, im31), (re61, im61))."""
    xp = ops31.xp
    d31 = ops31.norm(d)
    d61 = ops61.norm(d)
    z = xp.zeros_like(d)
    x31 = ops31.mul(t.p31.weights, (d31, z))
    x61 = ops61.mul(t.p61.weights, (d61, z))
    return plane_fwd(ops31, x31, t.p31), plane_fwd(ops61, x61, t.p61)


def inverse_3161(ops31: Fq2Ops, ops61: Fq2Ops, t: Tables3161, s31, s61):
    """Spectral pairs -> CRT-combined coefficients (lo64, hi) u64 pairs."""
    xp = ops31.xp
    y31 = plane_inv(ops31, s31, t.p31)
    y61 = plane_inv(ops61, s61, t.p61)
    c31 = ops31.mul(t.p31.unweights, y31)[0]   # im must vanish
    c61 = ops61.mul(t.p61.unweights, y61)[0]
    # CRT: v = c31 + q31 * ((c61 - c31) * q31^-1 mod q61)
    diff = ops61.subq(c61, ops61.norm(c31))
    tmul = ops61.mulq(diff, xp.uint64(t.crt_minv % M61))
    # v = c31 + M31 * tmul  (tmul < 2^61): 64x61-bit product as (lo, hi)
    M32 = xp.uint64(0xFFFFFFFF)
    a0 = tmul & M32
    a1 = tmul >> xp.uint64(32)
    q31 = xp.uint64(M31)
    p0 = a0 * q31                      # < 2^63
    p1 = a1 * q31                      # < 2^60
    lo = c31 + p0                      # < 2^64? c31 < 2^31, p0 < 2^63 ok
    mid = p1 + (lo >> xp.uint64(32))
    lo = (lo & M32) | ((mid & M32) << xp.uint64(32))
    hi = mid >> xp.uint64(32)
    return lo, hi


def carry_3161(xp, lo, hi, widths, masks, a=1):
    """Exact digit normalization of CRT coefficients (lo, hi < 2^28);
    optional small multiplier a < 2^16 folded before propagation (same
    adc_mul decomposition as the Goldilocks carry)."""
    w = widths
    d = lo & masks
    # carry = v >> w  (v < n * 2^(2w+2) so carry fits u64)
    c = (lo >> w) | (hi << (xp.uint64(64) - w))
    if not (isinstance(a, int) and a == 1):
        a64 = xp.uint64(a) if isinstance(a, int) else a
        t = d * a64
        c = c * a64 + (t >> w)
        d = t & masks

    def inject(c, d):
        c = xp.roll(c, 1)
        t = d + c
        return t >> w, t & masks

    if xp is np:
        c, d = inject(c, d)
        while bool((c != 0).any()):
            c, d = inject(c, d)
        return d
    from jax import lax
    c, d = inject(c, d)
    c, d = lax.while_loop(lambda st: xp.any(st[0] != xp.uint64(0)),
                          lambda st: inject(*st), (c, d))
    return d
