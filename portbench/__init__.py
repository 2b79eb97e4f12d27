"""The benchmark of the PyTorch and CUDA port (unav_yolyolva_tpu_torch) on
one NVIDIA H100: `python -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json once."""
