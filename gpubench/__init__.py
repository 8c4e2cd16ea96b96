"""gpubench: the benchmark of bert_tpu_torch, the PyTorch and CUDA port,
on an NVIDIA H100. ``python3 -m gpubench --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once (run.py; README.md)."""
