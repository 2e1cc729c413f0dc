"""tinyfaces_tpu_torch — the PyTorch/CUDA port of tinyfaces_tpu for NVIDIA
Hopper (H100).

The JAX package `tinyfaces_tpu` is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find:

  ops/       dense IoU, GT assignment (CUDA kernel + plain twin), sampling,
             box IoU, top-K decode, NMS, the pyramid resizes (linear and
             the reference's PIL bilinear)
  models/    ResNet backbone + 25-template detector heads (torch.nn)
  data/      templates, WIDER data (train augmentation, val/test), the
             GT-overflow accounting, the C++ augmentation engine's bindings,
             device-side target building, the batch loaders
  clustering/ k-medoids template clustering (host NumPy)
  parallel/  SIGTERM handling of a training run
  utils/     weight bridge to and from the JAX trees, native build helper,
             profiling, metrics log, box drawing
  csrc/      hand-written CUDA kernels and the C++ augmentation engine,
             built at first use
  config.py  the detector, train and eval configurations
  main.py, trainer.py
             the training CLI and its epoch loop
  evaluation.py, evaluate_model.py, detect_image.py, serving.py
             pyramid inference, its CLIs and the batching service
  metrics.py, wider_eval.py
             box metrics, VOC AP and the WIDER grader (NumPy)
  bench.py, bench_train.py
             the pyramid and train-step benches (one JSON line each)
  tools/     template clustering, the closed-loop accuracy tools (train
             soak, parity run, recall bands, e2e accuracy, AP cost) and the
             speed instruments (train, serving, sweep and loader benches,
             pipeline and device profiles, the jpegdct ceiling, the FLOP
             count, wire statistics)

It imports torch and never jax, and nothing of the JAX package either: what
it needs from there (the configurations, templates.json, the step timer,
the .npz reader, the C++ engine's source) it keeps as its own copy. PIL is
imported only inside the functions that decode, resize, draw or write
images.
"""

__version__ = "0.1.0"
