"""Engine factory and backend selection.

Analog of the reference's backend configuration + factory
(reference: src/marin/gpu.cpp:26-152 configure_gpu_backend/create_gpu).
Backends:
  * "jax"     — XLA device engine (any transform size; per-register rows
                at n >= 2^25)
  * "sharded" — the XLA engine with the digit vector split over a 1-D
                device mesh (parallel/sharded.py)
  * "numpy"   — host oracle engine (testing / tiny exponents)
  * "auto"    — jax, on the arithmetic path the workload-aware policy picks
                (the analog of src/aevum/AutoPolicy.cpp:36-152)

The choice depends only on what the code can observe — backend, arithmetic
path and transform size — never on the platform.
"""

from __future__ import annotations

import os
import sys

from .api import Engine

BACKENDS = ("auto", "jax", "numpy", "sharded")

_BACKEND = "auto"


def configure_backend(backend: str) -> None:
    global _BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    _BACKEND = backend


def resolve(p: int, backend: str | None = None, arith: str | None = None,
            workload: str = "generic") -> tuple[str, str]:
    """(backend, arith) that create_engine builds for exponent p."""
    b = backend or os.environ.get("PRMERS_BACKEND") or _BACKEND
    if b not in BACKENDS:
        raise ValueError(f"unknown backend {b!r}")
    a = arith or os.environ.get("PRMERS_ARITH") or "auto"
    if a == "auto":
        if b in ("numpy", "sharded"):
            # the host oracle and the mesh engine are gl64-only surfaces
            a = "gl64"
        else:
            from .policy import decide_arith
            a = decide_arith(p, workload).arith
    return ("jax" if b == "auto" else b), a


def engine_class(p: int, backend: str, arith: str) -> type:
    """The Engine subclass for a resolved (backend, arith) pair."""
    if arith == "fft3161":
        from .engine3161 import Engine3161
        return Engine3161
    if backend == "numpy":
        from .np_engine import NumpyEngine
        return NumpyEngine
    if backend == "sharded":
        from ..parallel.sharded import ShardedEngine
        return ShardedEngine
    from ..core.plan import cached_plan
    from .jax_engine import ROW_MODE_MIN_N, JaxEngine, JaxRowEngine
    return JaxRowEngine if cached_plan(p).n >= ROW_MODE_MIN_N else JaxEngine


def create_engine(p: int, reg_count: int, backend: str | None = None,
                  device=None, arith: str | None = None,
                  workload: str = "generic") -> Engine:
    eng = _create_engine(p, reg_count, backend=backend, device=device,
                         arith=arith, workload=workload)
    from ..core.profile import maybe_wrap
    return maybe_wrap(eng)


def _create_engine(p: int, reg_count: int, backend: str | None = None,
                   device=None, arith: str | None = None,
                   workload: str = "generic") -> Engine:
    b, a = resolve(p, backend, arith, workload)
    cls = engine_class(p, b, a)
    if a == "fft3161":
        if b == "numpy":
            import numpy as _np
            return cls(p, reg_count, xp=_np)
        from .. import jaxconf  # noqa: F401
        import jax.numpy as jnp
        return cls(p, reg_count, xp=jnp)
    if b != "jax":
        return cls(p, reg_count)
    # huge register counts spill to host via the LRU paging wrapper
    # (reference: engine_gpu host paging, include/marin/engine_gpu.h:2172)
    from ..core.plan import cached_plan
    from .paged import PagedEngine, device_reg_budget
    n = cached_plan(p).n
    budget = device_reg_budget(n, device=device)
    if os.environ.get("PRMERS_GPU_ALLOC_DIAG") == "1":
        # reference diagnostics spelling (README.md:580-590):
        # report the logical slab vs the device register budget
        gib = reg_count * n * 8 / (1 << 30)
        print(f"[ALLOC] logical regs={reg_count} slab={gib:.2f} GiB "
              f"device budget={budget} regs"
              f"{' -> host-paged LRU' if reg_count > budget else ''}",
              file=sys.stderr)
    if reg_count > budget:
        return PagedEngine(cls(p, budget, device=device), reg_count)
    return cls(p, reg_count, device=device)
