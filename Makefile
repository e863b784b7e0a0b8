# pcr-tpu developer entry points
PY ?= python

.PHONY: test bench smoke native patterns lint clean

test:
	$(PY) -m pytest tests/ -q

bench:    ## the 13-row benchmark (needs an NVIDIA GPU)
	$(PY) bench.py

smoke:    ## the main path on the GPU against the CPU oracle
	$(PY) chip_smoke.py

native:   ## force-build the C++ host kernels into the cache
	$(PY) -c "from pcr_tpu import native; assert native.available(); \
	print('native kernels OK,', native.lib().pcr_native_threads(), 'threads')"

patterns: ## render visual glyph patterns (CPU + GPU) and compare
	$(PY) scripts/patterns/generate_glyph_patterns.py --mode cpu
	$(PY) scripts/patterns/generate_glyph_patterns.py --mode gpu
	$(PY) scripts/patterns/compare_cpu_gpu_patterns.py

clean:
	rm -rf .pytest_cache $$(find . -name __pycache__)
