"""PyTorch/CUDA port of the lock-free DHT surrogate cache (``repro`` is the
JAX reference it is held against).  See README.md, "PyTorch/CUDA port"."""
