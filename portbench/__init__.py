"""Benchmark of the PyTorch/CUDA port ``multimodal_idbn_tpu_torch`` on
NVIDIA GPUs. ``run.py`` is the entry point; everything a cell needs is
found by the names in ``BENCHMARK.json`` at the root of the checkout."""
