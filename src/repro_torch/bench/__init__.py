"""Benchmark suites of the port (port of part of the ``benchmarks`` folder),
run on the card: ``python -m repro_torch.bench.<suite>``."""
