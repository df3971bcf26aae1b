"""Sharded checkpoints (parallel/shard_ckpt.py): per-process shard files
+ manifest, process-count-independent resume (VERDICT r3 missing #5 /
next-round #6). Integrity model mirrors the reference's checkpoint CRC
discipline (include/marin/file.h:16-45) at the distributed layer.
"""

import numpy as np
import pytest

import jax

from prmers_tpu.parallel import shard_ckpt


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from prmers_tpu.parallel.sharded import make_mesh
    return make_mesh(8)


P1279 = 1279
MP = (1 << P1279) - 1


def _mk_engine(mesh):
    from prmers_tpu.parallel.sharded import ShardedEngine
    return ShardedEngine(P1279, 3, mesh)


class TestShardCkptSharded:
    def test_roundtrip_same_mesh(self, mesh8, tmp_path):
        eng = _mk_engine(mesh8)
        eng.set_int(0, 0x5EED)
        eng.square_mul(0)
        eng.set(1, 77)
        eng.set_multiplicand(2, 1)      # spectral register round-trips
        meta = {"iteration": 41, "elapsed": 1.5}
        shard_ckpt.save_sharded(eng, str(tmp_path / "ck"), meta)

        eng2 = _mk_engine(mesh8)
        got = shard_ckpt.load_sharded(eng2, str(tmp_path / "ck"))
        assert got == meta
        assert eng2.get_int(0) == 0x5EED * 0x5EED % MP
        assert eng2.get_int(1) == 77
        # the restored spectral register still multiplies
        eng.mul(0, 2)
        eng2.mul(0, 2)
        assert eng2.get_int(0) == eng.get_int(0)

    def test_repartition_8_to_4(self, mesh8, tmp_path):
        from prmers_tpu.parallel.sharded import make_mesh
        eng = _mk_engine(mesh8)
        eng.set_int(0, 1234567)
        eng.square_mul(0)
        shard_ckpt.save_sharded(eng, str(tmp_path / "ck"), {"iteration": 1})

        mesh4 = make_mesh(4)
        eng4 = _mk_engine(mesh4)
        meta = shard_ckpt.load_sharded(eng4, str(tmp_path / "ck"))
        assert meta == {"iteration": 1}
        assert eng4.get_int(0) == 1234567 * 1234567 % MP
        # continue on the NEW partition and round-trip back to 8
        eng4.square_mul(0)
        shard_ckpt.save_sharded(eng4, str(tmp_path / "ck2"),
                                {"iteration": 2})
        eng8 = _mk_engine(mesh8)
        assert shard_ckpt.load_sharded(eng8, str(tmp_path / "ck2")) == \
            {"iteration": 2}
        assert eng8.get_int(0) == pow(1234567, 4, MP)

    def test_corrupt_file_rejected(self, mesh8, tmp_path):
        eng = _mk_engine(mesh8)
        eng.set_int(0, 99)
        shard_ckpt.save_sharded(eng, str(tmp_path / "ck"), {})
        f = tmp_path / "ck" / "shard_0.bin"
        blob = bytearray(f.read_bytes())
        blob[8] ^= 0xFF
        f.write_bytes(bytes(blob))
        eng2 = _mk_engine(mesh8)
        assert shard_ckpt.load_sharded(eng2, str(tmp_path / "ck")) is None

    def test_missing_manifest_is_aborted_save(self, mesh8, tmp_path):
        eng = _mk_engine(mesh8)
        eng.set_int(0, 5)
        shard_ckpt.save_sharded(eng, str(tmp_path / "ck"), {})
        (tmp_path / "ck" / "manifest.json").unlink()
        eng2 = _mk_engine(mesh8)
        assert shard_ckpt.load_sharded(eng2, str(tmp_path / "ck")) is None

    def test_wrong_shape_rejected(self, mesh8, tmp_path):
        eng = _mk_engine(mesh8)
        eng.set_int(0, 5)
        shard_ckpt.save_sharded(eng, str(tmp_path / "ck"), {})
        from prmers_tpu.parallel.sharded import ShardedEngine
        other = ShardedEngine(P1279, 5, mesh8)   # reg_count mismatch
        assert shard_ckpt.load_sharded(other, str(tmp_path / "ck")) is None
