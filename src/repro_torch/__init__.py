"""PyTorch + CUDA port of the W8A8 charge-domain CiM serving stack.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``configs``, ``core``, ``kernels``, ``models``, ``serve``,
``launch``) so each module's counterpart is found under the same name.
Every Pallas TPU kernel on the ported path is a hand-written CUDA C++
kernel for Hopper (``csrc/``), with a plain PyTorch twin beside it that
runs on CPU tensors.
"""
