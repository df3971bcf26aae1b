"""Multi-host scaffolding tests: a real 2-process jax.distributed group
over CPU devices runs the sharded engine and resumes a checkpoint written
single-process (SURVEY.md §5.8 — the reference has no distributed layer;
this is a new component, exercised here on CPU devices).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import numpy as np

sys.path.insert(0, os.environ["PRMERS_REPO"])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_ENABLE_X64"] = "1"

import jax
# pin the cpu client before the distributed client initializes, so an
# installed GPU plugin is not picked up
jax.config.update("jax_platforms", "cpu")

from prmers_tpu.parallel import dist
assert dist.init_from_env(), "distributed init failed"

jax.config.update("jax_enable_x64", True)
assert jax.process_count() == 2
assert len(jax.devices()) == 8          # 4 local x 2 processes

from prmers_tpu.parallel.sharded import ShardedEngine, make_mesh
from prmers_tpu.engine.api import Engine

# establish the cross-process collective context with a tiny op BEFORE
# the big per-process compiles stagger the processes (the gloo context
# init has a 30 s rendezvous window)
dist.barrier("warmup")

p = 1279
mp = (1 << p) - 1
eng = ShardedEngine(p, 2, make_mesh())
dist.barrier("tables")

print("MH: engine ready", jax.process_index(), flush=True)

# resume the state the single-process phase checkpointed
blob = open(os.environ["PRMERS_CKPT"], "rb").read()
eng.set_checkpoint(blob)
print("MH: checkpoint restored", flush=True)

for i in range(5):
    eng.square_mul(0, 1)
    print("MH: step", i, flush=True)
eng.sync()
v = eng.get_int(0)
print("MH: value gathered", flush=True)

dist.barrier("done")
if dist.is_primary():
    with open(os.environ["PRMERS_OUT"], "w") as f:
        f.write(str(v))
print("WORKER_OK", jax.process_index(), flush=True)
"""


_WORKER_GL = r"""
import os, sys
import numpy as np

sys.path.insert(0, os.environ["PRMERS_REPO"])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_ENABLE_X64"] = "1"

import jax
jax.config.update("jax_platforms", "cpu")

from prmers_tpu.parallel import dist
assert dist.init_from_env(), "distributed init failed"
jax.config.update("jax_enable_x64", True)
assert jax.process_count() == 2

from prmers_tpu.parallel import shard_ckpt
from prmers_tpu.parallel.sharded import ShardedEngine, make_mesh

dist.barrier("warmup")
p = 1279
mp = (1 << p) - 1
eng = ShardedEngine(p, 4, make_mesh())
dist.barrier("tables")

# resume the SINGLE-process sharded checkpoint on the 2-process mesh
meta = shard_ckpt.load_sharded(eng, os.environ["PRMERS_CKPT_DIR"])
assert meta == {"iteration": 5}, meta
print("MH: sharded ckpt restored (1 -> 2 procs)", flush=True)

# a full Gerbicz-style window: B squarings, accumulator multiply,
# then the verify replay from the last-good copy (all on-mesh ops)
B = 4
eng.copy(2, 0)                      # last-good state
eng.set(1, 1)                       # accumulator
eng.square_mul_seq(0, [1] * B)
eng.set_multiplicand(3, 0)
eng.mul(1, 3)                       # acc *= state
eng.square_mul_seq(2, [1] * B)      # replay
assert eng.is_equal(0, 2), "GL replay mismatch"
print("MH: GL window verified", flush=True)

# save a NEW sharded checkpoint from the 2-process group
shard_ckpt.save_sharded(eng, os.environ["PRMERS_CKPT_OUT"],
                        {"iteration": 5 + B})
dist.barrier("saved")
if dist.is_primary():
    with open(os.environ["PRMERS_OUT"], "w") as f:
        f.write(str(eng.get_int(1)))
print("WORKER_OK", jax.process_index(), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_resume(tmp_path):
    """Phase A (in-process, 8 virtual devices): run 5 squarings, write a
    checkpoint. Phase B (two real OS processes, 4 CPU devices each, one
    jax.distributed group): resume the checkpoint, continue 5 squarings.
    The result must equal 10 straight squarings — proving checkpoints are
    process-count independent and the distributed init path works."""
    from prmers_tpu.parallel.sharded import ShardedEngine, make_mesh
    import jax

    p = 1279
    mp = (1 << p) - 1
    seed = 0x5EED
    eng = ShardedEngine(p, 2, make_mesh(8))
    eng.set_int(0, seed)
    for _ in range(5):
        eng.square_mul(0, 1)
    blob = eng.get_checkpoint()
    ckpt = tmp_path / "phaseA.ckpt"
    ckpt.write_bytes(blob)

    # ground truth: 10 squarings of the seed
    want = seed
    for _ in range(10):
        want = want * want % mp

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    out = tmp_path / "result.txt"
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "PRMERS_REPO": os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            "PRMERS_COORDINATOR": f"127.0.0.1:{port}",
            "PRMERS_NUM_PROCS": "2",
            "PRMERS_PROC_ID": str(pid),
            "PRMERS_CKPT": str(ckpt),
            "PRMERS_OUT": str(out),
        })
        env.pop("PYTEST_CURRENT_TEST", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outputs = []
    for pr in procs:
        stdout, _ = pr.communicate(timeout=600)
        outputs.append(stdout.decode())
    for pr, txt in zip(procs, outputs):
        assert pr.returncode == 0, txt[-2000:]
        assert "WORKER_OK" in txt
    got = int(out.read_text())
    assert got == want


@pytest.mark.slow
def test_two_process_gl_window_sharded_ckpt(tmp_path):
    """Sharded checkpoints across process counts (VERDICT r3 #6):
    phase A (1 process) saves a per-shard checkpoint; phase B (2
    processes) resumes it, runs a GL-checked window, saves its own
    sharded checkpoint; phase C (1 process) resumes THAT and verifies
    the accumulator/state — 1 -> 2 -> 1 elasticity with integrity."""
    from prmers_tpu.parallel import shard_ckpt
    from prmers_tpu.parallel.sharded import ShardedEngine, make_mesh

    p = 1279
    mp = (1 << p) - 1
    seed = 0x5EED
    eng = ShardedEngine(p, 4, make_mesh(8))
    eng.set_int(0, seed)
    for _ in range(5):
        eng.square_mul(0, 1)
    ckdir = tmp_path / "ck_a"
    shard_ckpt.save_sharded(eng, str(ckdir), {"iteration": 5})

    x5 = pow(seed, 1 << 5, mp)
    B = 4
    want_state = pow(x5, 1 << B, mp)
    want_acc = want_state % mp        # acc = 1 * state after one block

    worker = tmp_path / "worker_gl.py"
    worker.write_text(_WORKER_GL)
    out = tmp_path / "acc.txt"
    ckout = tmp_path / "ck_b"
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "PRMERS_REPO": os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            "PRMERS_COORDINATOR": f"127.0.0.1:{port}",
            "PRMERS_NUM_PROCS": "2",
            "PRMERS_PROC_ID": str(pid),
            "PRMERS_CKPT_DIR": str(ckdir),
            "PRMERS_CKPT_OUT": str(ckout),
            "PRMERS_OUT": str(out),
        })
        env.pop("PYTEST_CURRENT_TEST", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for pr in procs:
        stdout, _ = pr.communicate(timeout=600)
        assert pr.returncode == 0, stdout.decode()[-2000:]
        assert b"WORKER_OK" in stdout
    assert int(out.read_text()) == want_acc

    # phase C: resume the 2-process checkpoint on ONE process
    eng2 = ShardedEngine(p, 4, make_mesh(8))
    meta = shard_ckpt.load_sharded(eng2, str(ckout))
    assert meta == {"iteration": 9}
    assert eng2.get_int(0) == want_state
    assert eng2.get_int(1) == want_acc
