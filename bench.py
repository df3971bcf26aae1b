"""Benchmark: PRP squarings/sec at p=136279841 on the attached GPU.

Prints the device on an earlier line and ONE JSON line last:
{"metric", "value", "unit", "vs_baseline", "device"}. Exits non-zero when
JAX finds no GPU. Baseline: ~1225 iter/s on an RTX 4090 (PRMERS_SCORE 100
card, reference README.md:983 / BASELINE.md).
"""

import json
import os
import sys
import time

BASELINE_4090 = 1225.0
P_BENCH = 136279841
CHUNK = 64          # squarings per dispatch in the timed region
ROUNDS = 3


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from prmers_tpu import jaxconf  # noqa: F401
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {json.dumps(device)}", flush=True)

    from prmers_tpu.engine.factory import create_engine
    eng = create_engine(P_BENCH, 2)
    eng.set(0, 3)
    eng._SEQ_CHUNK = CHUNK
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * CHUNK)      # compiles the timed chunk
    eng.sync()
    print(f"setup: {type(eng).__name__} n={eng.get_size()} first chunk "
          f"(compile + run) {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        eng.square_mul_seq(0, [1] * CHUNK)
    eng.sync()
    ips = ROUNDS * CHUNK / (time.perf_counter() - t0)
    print(json.dumps({
        "metric": f"PRP iter/s @ p={P_BENCH}",
        "value": round(ips, 2),
        "unit": "iter/s",
        "vs_baseline": round(ips / BASELINE_4090, 4),
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
