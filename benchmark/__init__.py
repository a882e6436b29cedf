"""The benchmark of the PyTorch/CUDA port: one command runs one cell once (``run.py``)."""
