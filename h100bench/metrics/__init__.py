"""One file a per-layer metric of ``BENCHMARK.json``, named as the metric:
``read(readings)`` -> its value, or None where the run has nothing to read
(``h100bench/readers.py`` holds the arithmetic)."""
