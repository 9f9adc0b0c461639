# Developer entry points (the reference's CMake targets, translated)
PY ?= python

.PHONY: test native bench bench-all corpora clean

native:            ## build the C scalar tier in-place
	$(PY) setup.py build_ext --inplace

test:              ## run the conformance suite on CPU
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

test-fast:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -x -k "not installation"

bench:             ## headline benchmark (one JSON line; needs a GPU)
	$(PY) bench.py

bench-all:         ## per-op host-API sweep
	$(PY) tools/bench_all.py

corpora:           ## generate per-script benchmark corpora
	$(PY) tools/gen_corpus.py --out corpora --mb 4

clean:
	rm -rf build corpora *.egg-info
	find . -name __pycache__ -type d | xargs rm -rf
