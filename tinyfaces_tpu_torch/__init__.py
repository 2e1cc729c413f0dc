"""tinyfaces_tpu_torch — the PyTorch/CUDA port of tinyfaces_tpu for NVIDIA
Hopper (H100).

The JAX package `tinyfaces_tpu` is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find:

  ops/     dense IoU, GT assignment (CUDA kernel + plain twin), sampling,
           box IoU, top-K decode, NMS, the pyramid resize
  models/  ResNet backbone + 25-template detector heads (torch.nn)
  data/    templates, WIDER evaluation data, device-side target building,
           the batch loader
  utils/   weight bridge to and from the JAX trees, CUDA build helper
  csrc/    hand-written CUDA kernels, built with nvcc at first use
  evaluation.py, evaluate_model.py, detect_image.py, serving.py
           pyramid inference, its CLIs and the batching service

It imports torch and never jax (PIL only inside the functions that decode
or draw images). From the JAX package it uses only the framework-free
`tinyfaces_tpu.config`, `tinyfaces_tpu.utils.profiling` and
`tinyfaces_tpu.utils.serialization`.
"""

__version__ = "0.1.0"
