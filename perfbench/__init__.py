"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the Forest
predicate engine under ad-hoc traffic.  Run one cell with
``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; ``BENCHMARK.json`` names the
cells."""
