.PHONY: test alias-tests bench smoke

test:
	python -m pytest tests/ -q

# Run the reference's own method suites unmodified through the drop-in
# alias (import hail -> hail_tpu); records the pass rate.
alias-tests:
	tools/alias_tests.sh 2>&1 | tee ALIAS_TESTS.log

bench:
	python bench.py

smoke:
	timeout 1200 python -u chip_smoke.py
