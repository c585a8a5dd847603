"""The benchmark of the PyTorch and CUDA port (``tpu_unet_torch``) on one
NVIDIA H100: ``python3 -m port_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and
prints one JSON line. See ``run.py``."""
