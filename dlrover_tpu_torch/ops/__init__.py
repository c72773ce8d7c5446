"""Ops of the port: plain PyTorch versions of the reference's ops, and
the wrappers of the hand-written CUDA kernels (``decode_attention``)."""
