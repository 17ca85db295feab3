"""portbench: the benchmark of tpt_torch, the PyTorch and CUDA port (see run.py)."""
