"""The port's benchmark: one cell of ``BENCHMARK.json`` run once by
``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. Everything that belongs to one configuration, traffic mix,
cell or metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it (``spec.py``)."""
