"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that measures (traffic, counts of operations and
bytes, peaks, trace reading, plain references, the comparison that
decides ``correct``) lives in this folder; from the port it takes only
the system under test.
"""
