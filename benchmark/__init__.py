"""The benchmark of niqki_tpu_torch, the PyTorch and CUDA port: cells of a
configuration and a traffic mix, run one at a time by ``run.py``. It imports
the port, torch and numpy, and never JAX or the JAX package."""
