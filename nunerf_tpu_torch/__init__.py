"""PyTorch/CUDA port of nunerf_tpu (stage-1 training slice)."""
