"""PyTorch/CUDA port of `pytorch_end2end_speech_recognition_tpu`.

The JAX package stays the reference; this package mirrors its layout
module by module, imports torch and numpy only, and replaces each Pallas
TPU kernel with a hand-written CUDA kernel for Hopper (`csrc/`), beside a
plain PyTorch version that the CPU path and the tests use.
"""
