"""CPU tests of the benchmark (``pytest perfbench/tests``)."""
