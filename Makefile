# Operator entry points, mirroring the reference's Makefile workflow
# (/root/reference/Makefile:27-63): one-command fake data, tests, and
# benchmarks.  The "binary" here is `python -m sybil_tpu`.
#
# Tests and data generation run on CPU (JAX_PLATFORMS=cpu) — the TPU
# admits one process at a time and the storage/CLI layers don't need it.
# Benchmarks run on whatever platform JAX resolves (the TPU when
# available).

PY      ?= python
SYBIL    = $(PY) -m sybil_tpu
CPUENV   = JAX_PLATFORMS=cpu
DB      ?= ./db

all: native

# Build the C++ WAL codec ahead of time (it also builds lazily on first
# digest; this target just surfaces compile errors early).
native:
	$(CPUENV) $(PY) -c "from sybil_tpu import native; assert native.available(), 'C++ walcodec failed to build'; print('native ok')"

# ---- fake data (Makefile:27-33) -------------------------------------
fake-data: fake-uptime fake-people

fake-uptime:
	$(PY) scripts/fakedata/host_generator.py 1000000 | $(CPUENV) $(SYBIL) ingest -dir $(DB) -table uptime
	$(CPUENV) $(SYBIL) digest -dir $(DB) -table uptime

fake-people:
	$(PY) scripts/fakedata/people_generator.py 50000 | $(CPUENV) $(SYBIL) ingest -dir $(DB) -table people
	$(CPUENV) $(SYBIL) digest -dir $(DB) -table people

fake-sessions:
	bash scripts/make_user_sessions.sh

testquery:
	$(CPUENV) $(SYBIL) query -dir $(DB) -table people -int age,f1 -op hist -group state

# ---- tests (Makefile:41-49) -----------------------------------------
test:
	$(PY) -m pytest tests/ -x -q

testv:
	DEBUG=1 $(PY) -m pytest tests/ -x -v

coverage:
	$(PY) -m pytest tests/ -q --cov=sybil_tpu --cov-report=term 2>/dev/null \
	  || $(PY) -m pytest tests/ -q  # coverage plugin optional

# ---- benchmarks (Makefile:62-63; BASELINE.md) -----------------------
bench:
	$(PY) bench.py

benchmarks: bench
	$(PY) scripts/bench_configs.py
	$(PY) scripts/bench_cache.py
	$(PY) scripts/bench_scaling.py

# per-shape device-time / roofline split (BASELINE.md round-5 table)
bench-device:
	$(PY) scripts/bench_device_time.py

# ingest + digestion rows/s (native C++ walcodec vs pure python)
bench-write:
	$(CPUENV) $(PY) scripts/bench_write_path.py

# HBM-overflow working set: LRU eviction + re-upload, never failure
bench-overflow:
	$(PY) scripts/bench_overflow.py

# CI regression gate (benchcmp analog; --update refreshes the baseline)
bench-gate:
	$(PY) scripts/bench_gate.py

# ---- ops / stress ---------------------------------------------------
# bounded by default; SOAK_ITERS=1000 for an hours-scale soak
soak:
	bash scripts/stress_ingest_digest.sh

# one-sided steady soaks against a live querier (steady_*.sh analogs)
soak-ingest:
	bash scripts/steady_ingest.sh

soak-digest:
	bash scripts/steady_digest.sh

demo:
	bash scripts/basic_aggregation_test.sh

# ---- PyTorch/CUDA port (sybil_tpu_torch) ----------------------------
# CPU tests of the port against sybil_tpu; the H100 smoke run builds the
# CUDA kernels and drives the port's main path on the card
test-torch:
	$(CPUENV) $(PY) -m pytest tests/test_torch_*.py -q

chip-smoke:
	$(PY) chip_smoke.py

clean:
	rm -rf $(DB) sybil_tpu/native/build/*.so sybil_tpu_torch/csrc/build

.PHONY: all native fake-data fake-uptime fake-people fake-sessions \
        testquery test testv coverage bench benchmarks bench-device \
        bench-write bench-overflow bench-gate soak soak-ingest \
        soak-digest demo clean test-torch chip-smoke
