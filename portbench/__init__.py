"""The benchmark of the PyTorch/CUDA port (see core.py and BENCHMARK.json)."""
