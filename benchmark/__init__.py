"""The benchmark of mot3d_tpu_torch on the GPU; `run.py` is its entry."""
