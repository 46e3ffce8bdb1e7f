# Developer entry points (the reference's per-language build commands —
# cargo test / go test / ./caf.py — unified).

.PHONY: test test-gpu smoke selftest bench configs scaling native fixtures figures clean

test:
	python -m pytest tests/ -q

# User-facing golden lane on the active device (exit 0 iff all 10 exact).
selftest:
	python -m caf_cookoff_tpu selftest --data data

# Compiled on-GPU lane (the gpu-marked tests; they skip without a GPU).
# chip_smoke.py runs the same lane in its own process.
test-gpu:
	CAF_TESTS_ON_GPU=1 python -m pytest tests/test_on_chip.py -q -m gpu

# Bring-up smoke test on one GPU (every engine, gated against a c128
# oracle); add --four-gpus for the 4-GPU mesh phase.
smoke:
	python chip_smoke.py

bench:
	python bench.py

configs:
	python bench_configs.py 1 2 3 4 5

# Scaling efficiency over an N-device mesh (BASELINE's 1->N deliverable):
# every attached GPU; --virtual 8 validates the harness, shardings and
# collectives on virtual CPU devices.
scaling:
	python bench_scaling.py --out chiprun_out/scaling_gpu.json
	python bench_scaling.py --virtual 8 --out chiprun_out/scaling_virtual8.json

# Contention-free strong-scaling measurement: N pinned-core processes
# (Gloo collectives, one XLA CPU device each) with measured
# compute-vs-collective attribution — the defensible N>=2 evidence
# (see ARCHITECTURE.md "Scaling evidence").
scaling-pinned:
	python bench_multiproc.py --out chiprun_out/scaling_pinned.json

native:
	$(MAKE) -C native

fixtures:
	python -m caf_cookoff_tpu generate --out data

figures:
	python docs/make_figures.py

clean:
	$(MAKE) -C native clean
	rm -rf .pytest_cache caf_cookoff_tpu/__pycache__
