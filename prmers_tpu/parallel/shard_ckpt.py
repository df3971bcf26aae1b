"""Sharded checkpoint save/load: per-process shard files + a manifest.

At flagship scale a full-register gather through one host does not fit
(n = 2^26 x 51 ECM registers ~ 27 GB); instead every PROCESS writes the
digit ranges its devices own to its own file, and the primary writes a
manifest mapping digit ranges to files. Loading is process-count
INDEPENDENT: each process reads exactly the ranges its (possibly
different) mesh partition needs via `jax.make_array_from_callback`, so a
run checkpointed on H hosts resumes on H' hosts (SURVEY §5.4 checkpoint
parity extended to the distributed layer; the reference is single-GPU —
include/marin/file.h:16-45 is the integrity model being mirrored:
CRC32 per file, atomic rename).

Layout of <dir>/:
  manifest.json               (primary only; written LAST = commit point)
  shard_<proc>.bin            one per process: concatenated u64-LE digit
                              ranges in manifest order, CRC32 trailer
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from . import dist


def _reg_digit_rows(eng, r: int):
    """[(start_digit, u64 digits)] for the locally-addressable pieces of
    register r, in canonical digit order, plus the spectral flag.

    ShardedEngine: regs is (reg_count, n) u64 sharded P(None, limb)."""
    rows = []
    row = eng.regs[r]
    spectral = r in getattr(eng, "_spec", set())
    for sh in row.addressable_shards:
        idx = sh.index[0]
        start = idx.start or 0
        rows.append((start, np.asarray(sh.data).reshape(-1)))
    return rows, spectral


def save_sharded(eng, dir_path: str, meta: dict) -> None:
    """Write a sharded checkpoint of every register. `meta` is the
    mode-level state (iteration, elapsed, extra...), stored verbatim in
    the manifest. Atomic: the manifest is written last; a directory
    without a manifest is an aborted save."""
    os.makedirs(dir_path, exist_ok=True)
    proc = 0
    try:
        import jax
        proc = jax.process_index()
    except Exception:
        pass
    entries = []        # [(reg, start, count)] in file order
    chunks = []
    spectral = {}
    for r in range(eng.reg_count):
        rows, is_spec = _reg_digit_rows(eng, r)
        spectral[r] = is_spec
        for start, data in rows:
            entries.append((r, int(start), int(data.size)))
            chunks.append(data.astype("<u8").tobytes())
    payload = b"".join(chunks)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    fname = f"shard_{proc}.bin"
    tmp = os.path.join(dir_path, fname + ".new")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.write(struct.pack("<I", crc))
    os.replace(tmp, os.path.join(dir_path, fname))

    # every process reports its entry table to the manifest through the
    # filesystem (process-local sidecars), primary commits the manifest
    side = os.path.join(dir_path, f"entries_{proc}.json")
    with open(side + ".new", "w") as f:
        json.dump(entries, f)
    os.replace(side + ".new", side)
    dist.barrier("shard_ckpt_files")

    if dist.is_primary():
        files = {}
        nproc = dist.process_count()
        for q in range(nproc):
            with open(os.path.join(dir_path, f"entries_{q}.json")) as f:
                files[f"shard_{q}.bin"] = json.load(f)
        manifest = {
            "version": 1,
            "p": eng.p,
            "n": eng.get_size(),
            "reg_count": eng.reg_count,
            "spectral": {str(k): v for k, v in spectral.items()},
            "meta": meta,
            "files": files,
        }
        tmp = os.path.join(dir_path, "manifest.json.new")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(dir_path, "manifest.json"))
    dist.barrier("shard_ckpt_commit")


class _ShardReader:
    """Random access into the shard files by (reg, digit range)."""

    def __init__(self, dir_path: str, manifest: dict):
        self.dir = dir_path
        # per reg: [(start, count, fname, byte_offset)]
        self.index: dict[int, list] = {}
        for fname, entries in manifest["files"].items():
            off = 0
            for reg, start, count in entries:
                self.index.setdefault(int(reg), []).append(
                    (int(start), int(count), fname, off))
                off += int(count) * 8
        for v in self.index.values():
            v.sort()
        self._fh = {}

    def _file(self, fname):
        if fname not in self._fh:
            self._fh[fname] = open(os.path.join(self.dir, fname), "rb")
        return self._fh[fname]

    def read_range(self, reg: int, start: int, count: int) -> np.ndarray:
        """u64 digits [start, start+count) of register reg, assembled
        from whichever files hold pieces of the range."""
        out = np.empty(count, dtype=np.uint64)
        filled = 0
        for estart, ecount, fname, off in self.index.get(reg, []):
            lo = max(start, estart)
            hi = min(start + count, estart + ecount)
            if lo >= hi:
                continue
            f = self._file(fname)
            f.seek(off + (lo - estart) * 8)
            buf = f.read((hi - lo) * 8)
            out[lo - start:hi - start] = np.frombuffer(buf, dtype="<u8")
            filled += hi - lo
        if filled != count:
            raise ValueError(
                f"checkpoint hole: reg {reg} range [{start},{start+count})"
                f" only {filled} digits present")
        return out

    def close(self):
        for f in self._fh.values():
            f.close()
        self._fh = {}


def verify_files(dir_path: str, manifest: dict) -> bool:
    """CRC32 check of every shard file present on this host (files for
    other hosts' shards may legitimately be absent on a shared-nothing
    filesystem — only the ranges a process reads need its files)."""
    for fname in manifest["files"]:
        path = os.path.join(dir_path, fname)
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            blob = f.read()
        payload, crc = blob[:-4], struct.unpack("<I", blob[-4:])[0]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return False
    return True


def load_sharded(eng, dir_path: str) -> dict | None:
    """Restore every register into `eng` (any process count / mesh
    partition). Returns the saved meta dict, or None if the directory
    has no committed manifest / fails integrity. Each process reads only
    the digit ranges its addressable shards cover."""
    mpath = os.path.join(dir_path, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if manifest.get("version") != 1 or manifest["p"] != eng.p or \
            manifest["n"] != eng.get_size() or \
            manifest["reg_count"] != eng.reg_count:
        return None
    if not verify_files(dir_path, manifest):
        return None
    reader = _ShardReader(dir_path, manifest)
    try:
        for r in range(eng.reg_count):
            spectral = manifest["spectral"].get(str(r), False)
            _set_reg_scattered(eng, r, reader, spectral)
    finally:
        reader.close()
    return manifest["meta"]


def _set_reg_scattered(eng, r: int, reader: _ShardReader,
                       spectral: bool) -> None:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from .sharded import LIMB

    # ShardedEngine: one (n,) u64 row
    n = eng.get_size()
    sharding = NamedSharding(eng.mesh, P(LIMB))

    def cb(idx):
        start = idx[0].start or 0
        stop = idx[0].stop if idx[0].stop is not None else n
        return reader.read_range(r, start, stop - start)

    row = jax.make_array_from_callback((n,), sharding, cb)
    eng.regs = eng.regs.at[r].set(row)
    if spectral:
        eng._spec.add(r)
    else:
        eng._spec.discard(r)
