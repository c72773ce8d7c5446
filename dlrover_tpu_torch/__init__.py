"""PyTorch/CUDA port of ``dlrover_tpu`` for NVIDIA Hopper (H100, sm_90a).

Module paths and names mirror the JAX package so each counterpart is
easy to find (``dlrover_tpu_torch.models.generate`` ports
``dlrover_tpu.models.generate``, and so on). The port imports ``torch``
and never ``jax`` or anything of ``dlrover_tpu``; where it needs a
JAX-free module of the reference it keeps its own copy.

Every TPU kernel on a ported path is a hand-written CUDA kernel under
``ops/csrc/``, built at first use (``ops/_ext.py``). Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU, where
each kernel wrapper runs its plain PyTorch version instead.
"""
