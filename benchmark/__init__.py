"""The benchmark of the PyTorch port (robustpointclouds_tpu_torch): one cell
a run, `python3 benchmark/run.py --workload W --seed N --seconds S --trace
0|1`, the cells in the checkout's BENCHMARK.json."""
