"""PyTorch/CUDA port of openhush_tpu: Whisper transcription on an NVIDIA
Hopper GPU, with hand-written CUDA kernels where the JAX package runs Pallas
kernels on the TPU. The JAX package stays the reference; this package
imports nothing of it."""

__version__ = "0.1.0"
