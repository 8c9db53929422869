# Developer / CI entry points (SURVEY.md §5 sanitizers & CI plan).
#
# Tiers (run on the CPU):
#   make ci-fast  red-flag layers: math/primitives/RNG twins, the plain
#                 paths vs brute force, folds (incl. goldens) under
#                 JAX_DEBUG_NANS + jax_enable_checks — any NaN anywhere in
#                 fwd/bwd raises.
#   make ci       ci-fast + the full suite on the virtual 8-device CPU mesh
#                 (dist, multiprocess, grads, train).
#   nightly: statistical-parity runs live in the full suite; run
#                 `pytest tests/test_statistical_parity.py` standalone.
# On a GPU machine: `make smoke` and `make bench`.
#
# The native BVH builder is rebuilt automatically by its ctypes loader;
# `make native` forces it.

PY ?= python

FAST_TESTS = tests/test_math.py tests/test_primitives.py \
             tests/test_rng_twins.py tests/test_accel_native.py \
             tests/test_film.py tests/test_plain_paths.py \
             tests/test_fold.py tests/test_camera_pose.py

GOLDEN_TESTS = tests/test_golden_images.py

.PHONY: ci ci-fast test nan-check goldens bench smoke native clean

ci: ci-fast test

ci-fast: nan-check goldens

nan-check:
	JAX_DEBUG_NANS=true JAX_ENABLE_CHECKS=true \
	$(PY) -m pytest $(FAST_TESTS) -q -x

goldens:
	$(PY) -m pytest $(GOLDEN_TESTS) -q

test:
	$(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

native:
	$(MAKE) -C native

clean:
	rm -rf native/*.so .jax_cache
