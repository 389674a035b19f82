"""PyTorch/CUDA port of nunerf_tpu: both training stages, their data layer
and loop, and the hand-written H100 kernels."""
