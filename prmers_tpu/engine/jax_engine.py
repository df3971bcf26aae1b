"""JAX device engine — the XLA compute path of the Engine API.

Registers live as one (reg_count, n) u64 slab on device (the analog of the
reference's register slab, reference: include/marin/engine_gpu.h:36-269).
Every op is a module-level jitted donated-state function taking the NTT tables
as a pytree argument, so compilations are shared across engine instances with
the same plan shape. `square_mul_seq` runs whole blocks of squarings in one
dispatch via lax.scan — the equivalent of the reference's enqueue-only hot
loop (reference: src/modes/RunPrpOrLlMarin.cpp:295-458).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

from .. import jaxconf  # noqa: F401  (must precede jax.numpy use)
import jax
import jax.numpy as jnp
from jax import lax

from ..core.field import FieldOps
from ..core.plan import Plan, cached_plan
from ..ops import carry as carry_ops
from ..ops import ntt
from .api import Engine, Reg

F = FieldOps(jnp)


# ---------------------------------------------------------------------------
# Module-level ops (jit-cached across engines by table structure/shapes)
# ---------------------------------------------------------------------------

def _carry(t, y, a):
    return carry_ops.carry_full(F, y, t.widths, t.masks, a, lax=lax)


def _square(t, x, a):
    s = ntt.forward(F, t, x)
    y = ntt.inverse(F, t, F.sqr(s))
    return _carry(t, y, a)


@functools.partial(jax.jit, donate_argnums=0)
def op_square_mul(regs, t, src, a):
    return regs.at[src].set(_square(t, regs[src], a))


@functools.partial(jax.jit, donate_argnums=0)
def op_square_mul_seq(regs, t, src, a_vec):
    def body(x, a):
        return _square(t, x, a), None
    x, _ = lax.scan(body, regs[src], a_vec)
    return regs.at[src].set(x)


@functools.partial(jax.jit, donate_argnums=0)
def op_square_sub2_seq(regs, t, src, count, delta):
    def body(i, x):
        x = _square(t, x, jnp.uint64(1))
        return _carry(t, x + delta, 1)
    x = lax.fori_loop(0, count, body, regs[src])
    return regs.at[src].set(x)


@functools.partial(jax.jit, donate_argnums=0)
def op_copy(regs, src_dst):
    dst, src = src_dst
    return regs.at[dst].set(regs[src])


@functools.partial(jax.jit, donate_argnums=0)
def op_set_multiplicand(regs, t, dst, src):
    m = ntt.forward(F, t, regs[src]).reshape(t.n)
    return regs.at[dst].set(m)


@functools.partial(jax.jit, donate_argnums=0)
def op_mul(regs, t, dst, src, a):
    x = ntt.forward(F, t, regs[dst])
    m = regs[src].reshape(t.C, t.R)
    y = ntt.inverse(F, t, F.mul(x, m))
    return regs.at[dst].set(_carry(t, y, a))


@functools.partial(jax.jit, donate_argnums=0)
def op_add(regs, t, dst, src):
    return regs.at[dst].set(_carry(t, regs[dst] + regs[src], 1))


@functools.partial(jax.jit, donate_argnums=0)
def op_sub_reg(regs, t, dst, src):
    comp = t.masks - regs[src]
    return regs.at[dst].set(_carry(t, regs[dst] + comp, 1))


@functools.partial(jax.jit, donate_argnums=0)
def op_add_vec(regs, t, dst, vec):
    return regs.at[dst].set(_carry(t, regs[dst] + vec, 1))


@functools.partial(jax.jit, donate_argnums=0)
def op_addsub(regs, t, sum_out, diff_out, a, b):
    s = _carry(t, regs[a] + regs[b], 1)
    d = _carry(t, regs[a] + (t.masks - regs[b]), 1)
    regs = regs.at[sum_out].set(s)
    return regs.at[diff_out].set(d)


@functools.partial(jax.jit, donate_argnums=0)
def op_set_row(regs, dst, row):
    return regs.at[dst].set(row)


_TABLES_CACHE: dict = {}


def _get_tables(plan: Plan, device) -> ntt.NttTables:
    """Build all transform tables on device in ONE jitted program (cached).
    Huge transforms use compact widths (u8, masks derived in-op)."""
    compact = plan.n >= (1 << 25)
    key = (plan.p, plan.n, repr(device))
    if key not in _TABLES_CACHE:
        with jax.default_device(device):
            w64 = jax.device_put(plan.widths.astype(np.uint64),
                                 device=device)
            build = jax.jit(functools.partial(
                lambda w, c: ntt.NttTables.from_plan(
                    plan, jnp, widths_arg=w, compact_widths=c), c=compact))
            t = build(w64)
            jax.block_until_ready(jax.tree_util.tree_leaves(t))
        _TABLES_CACHE[key] = t
    return _TABLES_CACHE[key]


class JaxEngine(Engine):
    def __init__(self, p: int, reg_count: int, plan: Plan | None = None,
                 device=None):
        super().__init__(p, reg_count)
        self.plan = plan if plan is not None else cached_plan(p)
        self.device = device if device is not None else jax.devices()[0]
        put = functools.partial(jax.device_put, device=self.device)
        self.t = _get_tables(self.plan, self.device)
        n = self.plan.n
        self.regs = put(jnp.zeros((reg_count, n), dtype=jnp.uint64))
        self._sub_cache: dict[int, jax.Array] = {}

    def get_size(self) -> int:
        return self.plan.n

    @property
    def widths(self) -> np.ndarray:
        return self.plan.widths

    @staticmethod
    def _i32(v):
        return jnp.int32(v)

    @staticmethod
    def _u64(v):
        return jnp.uint64(v)

    def set(self, dst: Reg, a: int) -> None:
        self.set_int(dst, a)

    def copy(self, dst: Reg, src: Reg) -> None:
        self.regs = op_copy(self.regs, (self._i32(dst), self._i32(src)))

    def square_mul(self, src: Reg, a: int = 1) -> None:
        self.regs = op_square_mul(self.regs, self.t, self._i32(src),
                                  self._u64(a))

    _SEQ_CHUNK = 256

    def square_mul_seq(self, src: Reg, a_vec: Sequence[int]) -> None:
        a = np.asarray(a_vec, dtype=np.uint64)
        k = self._SEQ_CHUNK
        off = 0
        while len(a) - off >= k:
            self.regs = op_square_mul_seq(
                self.regs, self.t, self._i32(src), jnp.asarray(a[off:off + k]))
            off += k
        rem = len(a) - off
        if rem > 0:
            # single variable-length tail dispatch (scan over the remainder)
            self.regs = op_square_mul_seq(
                self.regs, self.t, self._i32(src), jnp.asarray(a[off:]))

    def square_sub2_seq(self, src: Reg, count: int) -> None:
        if count <= 0:
            return
        self.regs = op_square_sub2_seq(
            self.regs, self.t, self._i32(src), jnp.int64(count),
            self._delta_vec(2))

    def set_multiplicand(self, dst: Reg, src: Reg) -> None:
        self.regs = op_set_multiplicand(
            self.regs, self.t, self._i32(dst), self._i32(src))

    def mul(self, dst: Reg, src: Reg, a: int = 1) -> None:
        self.regs = op_mul(self.regs, self.t, self._i32(dst), self._i32(src),
                           self._u64(a))

    def add(self, dst: Reg, src: Reg) -> None:
        self.regs = op_add(self.regs, self.t, self._i32(dst), self._i32(src))

    def sub_reg(self, dst: Reg, src: Reg) -> None:
        self.regs = op_sub_reg(self.regs, self.t, self._i32(dst),
                               self._i32(src))

    def addsub(self, sum_out: Reg, diff_out: Reg, a: Reg, b: Reg) -> None:
        self.regs = op_addsub(self.regs, self.t, self._i32(sum_out),
                              self._i32(diff_out), self._i32(a), self._i32(b))

    def _delta_vec(self, a: int) -> jax.Array:
        """Digits of (M_p - a) as a device vector (cached per a)."""
        if a not in self._sub_cache:
            from ..utils import digits as dg
            mp = (1 << self.p) - 1
            self._sub_cache[a] = jax.device_put(
                jnp.asarray(dg.int_to_digits((mp - a) % mp, self.widths)),
                self.device)
        return self._sub_cache[a]

    def sub(self, src: Reg, a: int) -> None:
        self.regs = op_add_vec(self.regs, self.t, self._i32(src),
                               self._delta_vec(a))

    def add_small(self, src: Reg, a: int) -> None:
        from ..utils import digits as dg
        vec = jnp.asarray(dg.int_to_digits(a, self.widths))
        self.regs = op_add_vec(self.regs, self.t, self._i32(src), vec)

    def sync(self) -> None:
        self.regs.block_until_ready()

    # -- host exchange ---------------------------------------------------
    def get_digits(self, src: Reg) -> np.ndarray:
        return np.asarray(self.regs[src])

    def set_digits(self, dst: Reg, digits: np.ndarray) -> None:
        row = jnp.asarray(np.asarray(digits, dtype=np.uint64))
        self.regs = op_set_row(self.regs, self._i32(dst), row)

    def get_raw(self, src: Reg) -> np.ndarray:
        return np.asarray(self.regs[src])

    def set_raw(self, dst: Reg, data: np.ndarray) -> None:
        self.set_digits(dst, data)


# ---------------------------------------------------------------------------
# Row-mode variant for huge transforms: beyond n = 2^25 each register
# lives as its own (n,) array and ops are row-wise, so no op touches the
# whole slab and registers can be freed one at a time. No donation:
# register aliasing after copy() makes donated buffers unsafe.
# ---------------------------------------------------------------------------

ROW_MODE_MIN_N = 1 << 25


@jax.jit
def rop_square(t, x, a):
    return _square(t, x, a)


@jax.jit
def rop_square_seq(t, x, a_vec):
    def body(x, a):
        return _square(t, x, a), None
    x, _ = lax.scan(body, x, a_vec)
    return x


@jax.jit
def rop_square_sub2_seq(t, x, count, delta):
    def body(i, x):
        x = _square(t, x, jnp.uint64(1))
        return _carry(t, x + delta, 1)
    return lax.fori_loop(0, count, body, x)


@jax.jit
def rop_fwd(t, x):
    return ntt.forward(F, t, x).reshape(t.n)


@jax.jit
def rop_mul(t, x, m, a):
    s = ntt.forward(F, t, x)
    y = ntt.inverse(F, t, F.mul(s, m.reshape(t.C, t.R)))
    return _carry(t, y, a)


@jax.jit
def rop_add(t, x, y):
    return _carry(t, x + y, 1)


def _masks_of(t):
    if t.masks is not None:
        return t.masks
    return (jnp.uint64(1) << t.widths.astype(jnp.uint64)) - jnp.uint64(1)


@jax.jit
def rop_sub_reg(t, x, y):
    return _carry(t, x + (_masks_of(t) - y), 1)


@jax.jit
def rop_add_vec(t, x, vec):
    return _carry(t, x + vec, 1)


@jax.jit
def rop_addsub(t, a, b):
    m = _masks_of(t)
    return _carry(t, a + b, 1), _carry(t, a + (m - b), 1)


class JaxRowEngine(JaxEngine):
    """JaxEngine with per-register (n,) arrays instead of the 2D slab."""

    def __init__(self, p: int, reg_count: int, plan: Plan | None = None,
                 device=None):
        Engine.__init__(self, p, reg_count)
        self.plan = plan if plan is not None else cached_plan(p)
        self.device = device if device is not None else jax.devices()[0]
        self.t = _get_tables(self.plan, self.device)
        n = self.plan.n
        zero = jax.device_put(jnp.zeros(n, dtype=jnp.uint64), self.device)
        self.rows = [zero for _ in range(reg_count)]
        self._sub_cache = {}

    def copy(self, dst: Reg, src: Reg) -> None:
        self.rows[dst] = self.rows[src]

    def square_mul(self, src: Reg, a: int = 1) -> None:
        self.rows[src] = rop_square(self.t, self.rows[src], self._u64(a))

    _SCAN_MAX_N = 1 << 26   # the scanned chain double-buffers the row;
    # beyond this the scan program alone overflows HBM — loop singles
    # (dispatch overhead is noise against ~1 s/iteration at such sizes)

    def square_mul_seq(self, src: Reg, a_vec: Sequence[int]) -> None:
        a = np.asarray(a_vec, dtype=np.uint64)
        if self.plan.n > self._SCAN_MAX_N:
            for ai in a.tolist():
                self.rows[src] = rop_square(self.t, self.rows[src],
                                            jnp.uint64(ai))
            return
        k = self._SEQ_CHUNK
        off = 0
        while len(a) - off >= k:
            self.rows[src] = rop_square_seq(self.t, self.rows[src],
                                            jnp.asarray(a[off:off + k]))
            off += k
        if len(a) - off > 0:
            self.rows[src] = rop_square_seq(self.t, self.rows[src],
                                            jnp.asarray(a[off:]))

    def square_sub2_seq(self, src: Reg, count: int) -> None:
        if count <= 0:
            return
        self.rows[src] = rop_square_sub2_seq(
            self.t, self.rows[src], jnp.int64(count), self._delta_vec(2))

    def set_multiplicand(self, dst: Reg, src: Reg) -> None:
        self.rows[dst] = rop_fwd(self.t, self.rows[src])

    def mul(self, dst: Reg, src: Reg, a: int = 1) -> None:
        self.rows[dst] = rop_mul(self.t, self.rows[dst], self.rows[src],
                                 self._u64(a))

    def add(self, dst: Reg, src: Reg) -> None:
        self.rows[dst] = rop_add(self.t, self.rows[dst], self.rows[src])

    def sub_reg(self, dst: Reg, src: Reg) -> None:
        self.rows[dst] = rop_sub_reg(self.t, self.rows[dst], self.rows[src])

    def addsub(self, sum_out: Reg, diff_out: Reg, a: Reg, b: Reg) -> None:
        s, d = rop_addsub(self.t, self.rows[a], self.rows[b])
        self.rows[sum_out] = s
        self.rows[diff_out] = d

    def sub(self, src: Reg, a: int) -> None:
        self.rows[src] = rop_add_vec(self.t, self.rows[src],
                                     self._delta_vec(a))

    def add_small(self, src: Reg, a: int) -> None:
        from ..utils import digits as dg
        vec = jnp.asarray(dg.int_to_digits(a, self.widths))
        self.rows[src] = rop_add_vec(self.t, self.rows[src], vec)

    def sync(self) -> None:
        jax.block_until_ready(self.rows)

    _XFER_CHUNK = 1 << 24   # 128 MB host-transfer pieces

    def get_digits(self, src: Reg) -> np.ndarray:
        row = self.rows[src]
        n = row.shape[0]
        ch = self._XFER_CHUNK
        if n <= ch:
            return np.asarray(row)
        # chunked device->host: a whole-row transfer needs a contiguous
        # staging buffer that a fragmented HBM may not have
        return np.concatenate([np.asarray(row[i:i + ch])
                               for i in range(0, n, ch)])

    def set_digits(self, dst: Reg, digits: np.ndarray) -> None:
        host = np.asarray(digits, dtype=np.uint64)
        n = host.shape[0]
        ch = self._XFER_CHUNK
        if n <= ch:
            self.rows[dst] = jax.device_put(jnp.asarray(host), self.device)
            return
        parts = [jax.device_put(jnp.asarray(host[i:i + ch]), self.device)
                 for i in range(0, n, ch)]
        self.rows[dst] = jnp.concatenate(parts)

    def get_raw(self, src: Reg) -> np.ndarray:
        return self.get_digits(src)

    def set_raw(self, dst: Reg, data: np.ndarray) -> None:
        self.set_digits(dst, data)
