"""The benchmark of ``text2video_tpu_torch`` (``python3 -m benchmark.run``).

It measures the PyTorch and CUDA port only; nothing here imports JAX or the
JAX package ``text2video_tpu``.
"""
