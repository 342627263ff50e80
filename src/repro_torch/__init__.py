"""PyTorch + CUDA port of the ``repro`` serving stack.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``models``, ``kernels``, ``serve``, ``obs``, ``core``,
``launch``) and is held against it by the ``tests/test_torch_*`` suites.
It imports ``torch`` and numpy only — never ``jax``, and nothing of
``repro`` — so it runs on a machine without either.

Entry points take ``device=`` and default to ``"cuda"``; tensors on the CPU
take each kernel's plain PyTorch version, tensors on a CUDA device launch
the hand-written Hopper kernel (``kernels/csrc``) or raise.
"""
