"""The benchmark of nestmc_torch, the PyTorch and CUDA sampler, on H100 cards.

``python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Every
configuration, cell, sharding layout ("traffic") and metric lives in a file
of its own under this folder (configs/, workloads/, traffic/, metrics/),
found by the name ``BENCHMARK.json`` gives it, and every model that a
configuration names in a module of its own (models/). The yardstick (the
data generators, the bulk-ESS estimator, the peaks and work counts of the
roofline and the plain references that decide ``correct``) is frozen here
and imports nothing of the program.
"""
