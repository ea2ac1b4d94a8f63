"""The benchmark of the PyTorch/CUDA port of the speech recognizer.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` once on the card and prints one
JSON result line. Configurations, traffic mixes, correctness limits,
metric readers and work counts are files found by name (`configs/`,
`traffic/`, `limits/`, `metrics/`, `counts/`), and a configuration's model
family by its `family` (`reference/<family>.py`, `paths/<family>.py`).
"""
