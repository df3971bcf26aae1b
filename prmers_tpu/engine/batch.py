"""Curve-batched engine: one register slab with a leading CURVE axis.

The reference runs ECM curves strictly sequentially on one GPU queue
(reference: src/modes/RunEcm.cpp:185 per-curve loop); here the natural
formulation is SPMD over the curve axis — every Engine op applies the
same schedule to all lanes at once (jax.vmap over the single-engine op
bodies), so K curves cost one curve's dispatch overhead and each kernel sees
K-fold wider batches. Host-side divergence (gcd hits, failed
inversions, backtracks) is resolved per lane by the mode driver.

Registers: (reg_count, B, n) u64 slab. The op surface mirrors
engine.api.Engine for everything the ECM/P-1 drivers use, plus per-lane
set_int/get_int.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import jaxconf  # noqa: F401
import jax
import jax.numpy as jnp

from ..core.plan import Plan, cached_plan
from ..utils import digits as dg
from . import jax_engine as je


def _vm(fn):
    """vmap a (n,)-state op body over the batch axis."""
    return jax.vmap(fn)


@functools.partial(jax.jit, donate_argnums=0)
def bop_square_mul(regs, t, src, a):
    y = _vm(lambda x: je._square(t, x, a))(regs[src])
    return regs.at[src].set(y)


@functools.partial(jax.jit, donate_argnums=0)
def bop_square_mul_seq(regs, t, src, a_vec):
    from jax import lax

    def body(x, a):
        return _vm(lambda v: je._square(t, v, a))(x), None

    x, _ = lax.scan(body, regs[src], a_vec)
    return regs.at[src].set(x)


@functools.partial(jax.jit, donate_argnums=0)
def bop_copy(regs, src_dst):
    dst, src = src_dst
    return regs.at[dst].set(regs[src])


@functools.partial(jax.jit, donate_argnums=0)
def bop_set_multiplicand(regs, t, dst, src):
    m = _vm(lambda x: je.ntt.forward(je.F, t, x).reshape(t.n))(regs[src])
    return regs.at[dst].set(m)


@functools.partial(jax.jit, donate_argnums=0)
def bop_mul(regs, t, dst, src, a):
    def one(x, mflat):
        s = je.ntt.forward(je.F, t, x)
        y = je.ntt.inverse(je.F, t, je.F.mul(s, mflat.reshape(t.C, t.R)))
        return je._carry(t, y, a)

    y = jax.vmap(one)(regs[dst], regs[src])
    return regs.at[dst].set(y)


@functools.partial(jax.jit, donate_argnums=0)
def bop_add(regs, t, dst, src):
    y = _vm(lambda u, v: je._carry(t, u + v, 1))(regs[dst], regs[src])
    return regs.at[dst].set(y)


@functools.partial(jax.jit, donate_argnums=0)
def bop_sub_reg(regs, t, dst, src):
    y = _vm(lambda u, v: je._carry(t, u + (t.masks - v), 1))(
        regs[dst], regs[src])
    return regs.at[dst].set(y)


@functools.partial(jax.jit, donate_argnums=0)
def bop_addsub(regs, t, sum_out, diff_out, a, b):
    s = _vm(lambda u, v: je._carry(t, u + v, 1))(regs[a], regs[b])
    d = _vm(lambda u, v: je._carry(t, u + (t.masks - v), 1))(
        regs[a], regs[b])
    regs = regs.at[sum_out].set(s)
    return regs.at[diff_out].set(d)


@functools.partial(jax.jit, donate_argnums=0)
def bop_add_vec(regs, t, dst, vec):
    y = _vm(lambda u: je._carry(t, u + vec, 1))(regs[dst])
    return regs.at[dst].set(y)


@functools.partial(jax.jit, donate_argnums=0)
def bop_set_row_all(regs, dst, row):
    B = regs.shape[1]
    return regs.at[dst].set(jnp.broadcast_to(row, (B,) + row.shape))


@functools.partial(jax.jit, donate_argnums=(0,))
def bop_set_row_lane(regs, dst, lane, row):
    return regs.at[dst, lane].set(row)


class BatchJaxEngine:
    """Batched register file over the XLA NTT path (see module doc)."""

    def __init__(self, p: int, reg_count: int, batch: int,
                 plan: Plan | None = None):
        self.p = p
        self.reg_count = reg_count
        self.batch = batch
        self.plan = plan if plan is not None else cached_plan(p)
        self.n = self.plan.n
        dev = jax.devices()[0]
        self.t = je._get_tables(self.plan, dev)
        self.regs = jnp.zeros((reg_count, batch, self.n), jnp.uint64)

    def get_size(self) -> int:
        return self.n

    @property
    def widths(self) -> np.ndarray:
        return self.plan.widths

    # -- ops (same schedule on every lane) ---------------------------------
    def set(self, dst: int, a: int) -> None:
        row = np.zeros(self.n, dtype=np.uint64)
        row[0] = a
        self.regs = bop_set_row_all(self.regs, dst, jnp.asarray(row))

    def set_int(self, dst: int, v: int, lane: int | None = None) -> None:
        row = jnp.asarray(dg.int_to_digits(v, self.plan.widths))
        if lane is None:
            self.regs = bop_set_row_all(self.regs, dst, row)
        else:
            self.regs = bop_set_row_lane(self.regs, dst, lane, row)

    def get_int(self, src: int, lane: int) -> int:
        row = np.asarray(self.regs[src, lane])
        return dg.digits_to_int(row, self.plan.widths)

    def copy(self, dst: int, src: int) -> None:
        if dst != src:
            self.regs = bop_copy(self.regs, (dst, src))

    def square_mul(self, src: int, a: int = 1) -> None:
        self.regs = bop_square_mul(self.regs, self.t, src, jnp.uint64(a))

    def square_mul_seq(self, src: int, a_vec) -> None:
        self.regs = bop_square_mul_seq(
            self.regs, self.t, src,
            jnp.asarray(np.asarray(a_vec, dtype=np.uint64)))

    def set_multiplicand(self, dst: int, src: int) -> None:
        self.regs = bop_set_multiplicand(self.regs, self.t, dst, src)

    def mul(self, dst: int, src: int, a: int = 1) -> None:
        self.regs = bop_mul(self.regs, self.t, dst, src, jnp.uint64(a))

    def add(self, dst: int, src: int) -> None:
        self.regs = bop_add(self.regs, self.t, dst, src)

    def sub_reg(self, dst: int, src: int) -> None:
        self.regs = bop_sub_reg(self.regs, self.t, dst, src)

    def addsub(self, sum_out: int, diff_out: int, a: int, b: int) -> None:
        self.regs = bop_addsub(self.regs, self.t, sum_out, diff_out, a, b)

    def sync(self) -> None:
        jax.block_until_ready(self.regs)
