"""The benchmark of the PyTorch and CUDA package `yasph2d_tpu_torch`.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once on one CUDA device and prints one JSON
line. Everything that belongs to one configuration, traffic mix, cell, scene
or metric is a file of its own, found by the name `BENCHMARK.json` gives it
(`registry.py`).
"""
