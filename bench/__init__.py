"""The fleet sweep's benchmark: one cell of ``BENCHMARK.json`` a run
(``python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``)."""
