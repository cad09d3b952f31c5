"""The benchmark of the PyTorch/CUDA port ``occuspytial_tpu_torch`` on one
NVIDIA H100: ``python3 -m h100bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py`` and ``README.md``)."""
