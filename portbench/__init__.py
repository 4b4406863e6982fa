"""The benchmark of nestmc_torch, the PyTorch and CUDA sampler, on H100 cards.

``python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Every
configuration, cell, sharding layout ("traffic") and metric lives in a file
of its own under this folder (configs/, workloads/, traffic/, metrics/),
found by the name ``BENCHMARK.json`` gives it. The yardstick (the data
generator, the bulk-ESS estimator, the roofline counts and the plain
reference that decides ``correct``) is frozen here and imports nothing of
the program.
"""
