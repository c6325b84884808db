"""siggan_tpu_torch: the signature GAN on PyTorch and CUDA (NVIDIA Hopper).

A port of ``siggan_tpu`` that imports neither JAX nor ``siggan_tpu``. The
serving path (checkpoint -> generator session -> HTTP API) runs here; the
64 px unconditional generator's eval forward goes through hand-written CUDA
kernels (``csrc/``) when the checkpoint's sidecar sets ``use_pallas``. The
training path (``cli.train`` -> ``GANTrainer`` -> the resident train step)
trains unconditional and conditional (per-writer, v2.0) models on one card,
with DiffAugment, LR schedules and a generator EMA; every train-mode
generator forward packs its tail weights with a hand-written kernel (and
its backward), and every discriminator step runs the generator's tail in
another. The evaluation path (``cli.evaluate``, the trainer's FID) scores
samples with InceptionV3 FID / KID / precision-recall, LPIPS-Alex and
stroke statistics (``eval/``).
"""

__version__ = "0.1.0"
