"""The benchmark of the PyTorch/CUDA port (``probing_rag_tpu_torch``).
``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once."""
