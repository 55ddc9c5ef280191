"""text2video_tpu_torch — the PyTorch/CUDA port of ``text2video_tpu``.

It mirrors the JAX package's module names, runs on one NVIDIA Hopper card
(or on the CPU through the kernels' plain PyTorch versions), and never
imports JAX. The jax-free host modules of ``text2video_tpu`` (config,
keypoint I/O, timestamps, the pose planner and the host smoother, the stage
timer) are shared, not copied.

This slice covers the serving path: pose stage -> rasterizer ->
autoregressive ``CompositeGenerator`` -> uint8 / YUV420 frames -> host.
"""

__version__ = "0.1.0"
