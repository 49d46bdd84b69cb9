"""rtbench: the benchmark of pathtracing_tpu_torch on one NVIDIA H100.

`python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once (README.md).
"""
