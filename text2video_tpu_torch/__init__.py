"""text2video_tpu_torch — the PyTorch/CUDA port of ``text2video_tpu``.

It mirrors the JAX package's module names, runs on one NVIDIA Hopper card
(or, when the caller asks for the CPU, through the kernels' plain PyTorch
versions), and imports neither JAX nor the JAX package: the host modules
it needs (config, keypoint I/O, timestamps, the pose planner and the host
smoother, the muxers, the stage timer) are its own copies.

It covers text or audio in, video out (``cli.py``): the host frontend
(TTS, forced alignment, pinyin) -> pose stage -> rasterizer ->
autoregressive ``CompositeGenerator``, one utterance or a batch -> uint8 /
YUV420 frames -> host -> muxer.
"""

__version__ = "0.3.0"
