"""Host-paged register engine: logical registers beyond device capacity.

Analog of the reference's LRU host-paging engine for huge register-count
workloads (reference: include/marin/engine_gpu.h:2172-2644 `engine_gpu` —
logical regs spill to host `_backing` vectors, `_logical_to_slot` +
`_slot_clock` LRU). Here: wraps ANY inner Engine whose reg_count is
the device slot budget; cold registers live as host numpy arrays and move
via get_raw/set_raw (device_put/get streams underneath the jax engines).

Every primitive op pins its operands resident (evicting the
least-recently-used non-pinned slot) and delegates with slot indices; the
base-class derived ops (pow, addsub, square_mul_seq, checkpoints) then
work unchanged on logical indices.

Eviction is write-back with DIRTY TRACKING: a page-in keeps the host
copy, and ops mark only the registers they WRITE. Evicting a clean
register is free (the host copy is still current) — so read-mostly
access patterns (the stage-2 baby table scanned by every giant step,
prepared ECM quads) pay one host->device transfer per residency instead
of a full round trip per eviction.
"""

from __future__ import annotations

import numpy as np

from .api import Engine, Reg


class PagedEngine(Engine):
    def __init__(self, inner: Engine, logical_count: int):
        super().__init__(inner.p, logical_count)
        assert logical_count >= inner.reg_count
        self.inner = inner
        self.slots = inner.reg_count
        self._slot_of: dict[int, int] = {}        # logical -> slot
        self._logical_at: list[int | None] = [None] * self.slots
        self._lru = [0] * self.slots
        self._clock = 0
        # evicted logical -> (raw dump, is_spectral): the tag must travel
        # with the page so a paged-out multiplicand survives the round trip
        self._host: dict[int, tuple[np.ndarray, bool]] = {}
        self._dirty = [False] * self.slots
        self.page_ins = 0
        self.page_outs = 0
        self.clean_evictions = 0

    # -- paging core -------------------------------------------------------
    def _touch(self, slot: int):
        self._clock += 1
        self._lru[slot] = self._clock

    def _ensure(self, *logical: int, write: tuple[int, ...] = ()
                ) -> list[int]:
        """Pin the logical registers resident; `write` lists the POSITIONS
        in `logical` the caller will mutate (marks those slots dirty and
        invalidates their kept host copies)."""
        pinned = set()
        out = []
        for lg in logical:
            if lg in self._slot_of:
                s = self._slot_of[lg]
            else:
                s = self._evict_one(pinned)
                old = self._logical_at[s]
                if old is not None:
                    if self._dirty[s] or old not in self._host:
                        self._host[old] = self.inner.get_raw_tagged(s)
                        self.page_outs += 1
                    else:
                        self.clean_evictions += 1  # host copy is current
                    del self._slot_of[old]
                if lg in self._host:
                    data, spec = self._host[lg]
                    self.inner.set_raw_tagged(s, data, spec)
                    self.page_ins += 1
                else:
                    self.inner.set_raw(
                        s, np.zeros(self.inner.get_size(), dtype=np.uint64))
                self._slot_of[lg] = s
                self._logical_at[s] = lg
                self._dirty[s] = False
            self._touch(s)
            pinned.add(s)
            out.append(s)
        for pos in write:
            s = out[pos]
            self._dirty[s] = True
            # the kept host copy is stale the moment the device writes
            self._host.pop(self._logical_at[s], None)
        return out

    def _evict_one(self, pinned: set[int]) -> int:
        free = [s for s in range(self.slots)
                if self._logical_at[s] is None and s not in pinned]
        if free:
            return free[0]
        cands = [s for s in range(self.slots) if s not in pinned]
        return min(cands, key=lambda s: self._lru[s])

    # -- helpers -----------------------------------------------------------
    def get_size(self) -> int:
        return self.inner.get_size()

    @property
    def widths(self) -> np.ndarray:
        return self.inner.widths

    def sync(self) -> None:
        self.inner.sync()

    # -- primitive ops (delegate with slot mapping) -------------------------
    def set(self, dst: Reg, a: int) -> None:
        (s,) = self._ensure(dst, write=(0,))
        self.inner.set(s, a)

    def copy(self, dst: Reg, src: Reg) -> None:
        sd, ss = self._ensure(dst, src, write=(0,))
        self.inner.copy(sd, ss)

    def square_mul(self, src: Reg, a: int = 1) -> None:
        (s,) = self._ensure(src, write=(0,))
        self.inner.square_mul(s, a)

    def set_multiplicand(self, dst: Reg, src: Reg) -> None:
        sd, ss = self._ensure(dst, src, write=(0,))
        self.inner.set_multiplicand(sd, ss)

    def mul(self, dst: Reg, src: Reg, a: int = 1) -> None:
        sd, ss = self._ensure(dst, src, write=(0,))
        self.inner.mul(sd, ss, a)

    def sub(self, src: Reg, a: int) -> None:
        (s,) = self._ensure(src, write=(0,))
        self.inner.sub(s, a)

    def add_small(self, src: Reg, a: int) -> None:
        (s,) = self._ensure(src, write=(0,))
        self.inner.add_small(s, a)

    def add(self, dst: Reg, src: Reg) -> None:
        sd, ss = self._ensure(dst, src, write=(0,))
        self.inner.add(sd, ss)

    def sub_reg(self, dst: Reg, src: Reg) -> None:
        sd, ss = self._ensure(dst, src, write=(0,))
        self.inner.sub_reg(sd, ss)

    # -- host exchange -----------------------------------------------------
    def get_digits(self, src: Reg) -> np.ndarray:
        (s,) = self._ensure(src)
        return self.inner.get_digits(s)

    def set_digits(self, dst: Reg, digits: np.ndarray) -> None:
        (s,) = self._ensure(dst, write=(0,))
        self.inner.set_digits(s, digits)

    def get_raw(self, src: Reg) -> np.ndarray:
        # a resident slot is authoritative (a kept host copy may only
        # exist for CLEAN residents, where both are identical)
        if src not in self._slot_of and src in self._host:
            return self._host[src][0].copy()
        (s,) = self._ensure(src)
        return self.inner.get_raw(s)

    def get_raw_tagged(self, src: Reg) -> tuple[np.ndarray, bool]:
        if src not in self._slot_of and src in self._host:
            data, spec = self._host[src]
            return data.copy(), spec
        (s,) = self._ensure(src)
        return self.inner.get_raw_tagged(s)

    def set_raw(self, dst: Reg, data: np.ndarray) -> None:
        (s,) = self._ensure(dst, write=(0,))
        self.inner.set_raw(s, data)

    def set_raw_tagged(self, dst: Reg, data: np.ndarray,
                       spectral: bool = False) -> None:
        (s,) = self._ensure(dst, write=(0,))
        self.inner.set_raw_tagged(s, data, spectral)


def device_memory_bytes(device=None) -> int:
    """Bytes the device's allocator may hand out.

    A GPU reports its pool in memory_stats()["bytes_limit"]. The CPU
    backend reports no stats; its registers live in host memory, so the
    host's physical memory is the limit. Any other device without a
    limit is an error, not a guess."""
    import os

    from .. import jaxconf  # noqa: F401
    import jax
    dev = device if device is not None else jax.devices()[0]
    stats = dev.memory_stats() or {}
    if stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise RuntimeError(f"device {dev.device_kind!r} reports no memory "
                       "limit; pass -memlim")


def device_reg_budget(n: int, hbm_bytes: int | None = None,
                      device=None) -> int:
    """How many n-word u64 registers fit the device.

    Tables (weights/masks/widths/mids ~ 5 register-equivalents) and XLA
    transform temporaries are charged as a fixed overhead, so huge
    transforms get a small slot count instead of running out of memory.
    The memory comes from -memlim (PRMERS_MEMLIM_MB) when set, else from
    the device itself (device_memory_bytes)."""
    import os
    env = os.environ.get("PRMERS_MAX_DEVICE_REGS")
    if env:
        return max(int(env), 2)
    if hbm_bytes is None:
        memlim = os.environ.get("PRMERS_MEMLIM_MB")  # -memlim (MiB)
        if memlim:
            hbm_bytes = int(memlim) << 20
        else:
            hbm_bytes = device_memory_bytes(device)
    total = int(hbm_bytes * 0.95) // (8 * n)
    # fixed overhead: tables ~5 register-equivalents + XLA transform
    # temporaries ~4-5 + a transient host-transfer buffer. Every primitive
    # op pins at most two registers, so 2 slots always suffice.
    return max(total - 11, 2)
