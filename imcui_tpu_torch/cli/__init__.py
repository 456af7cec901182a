"""Command line of the PyTorch/CUDA port (``main.py``)."""
