# Operator convenience targets (the package itself needs no build step).

PY ?= python

.PHONY: test test-heavy test-all test-gpu test-matrix bench chip-smoke tune smoke clean

test:            ## smoke tier: the CPU guard rail (8-virtual-device mesh)
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
	  $(PY) -m pytest tests/ -q

test-heavy:      ## + multi-minute compile/e2e tests
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
	  $(PY) -m pytest tests/ -q --run-heavy

test-all:        ## everything incl. the slow golden runs
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
	  $(PY) -m pytest tests/ -q --run-slow

test-gpu:        ## the tests marked gpu, on the card
	JAX_PLATFORMS=cuda $(PY) -m pytest -m gpu tests/ -q

test-matrix:     ## backend x arithmetic x mode residue/factor cross-check
	JAX_PLATFORMS=cpu $(PY) tools/validation_matrix.py standard matrix.tsv

bench:           ## headline PRP iter/s JSON line (GPU)
	$(PY) bench.py

chip-smoke:      ## main path at full width on one GPU, then goldens
	$(PY) chip_smoke.py

tune:            ## measure + persist per-size rates (device)
	$(PY) -m prmers_tpu -tune

smoke:           ## first-GL-window ladder (device or CPU with a cap)
	$(PY) tools/gl_smoke.py

clean:
	rm -rf __pycache__ prmers_tpu/**/__pycache__ .pytest_cache matrix.tsv
