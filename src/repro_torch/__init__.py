"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

The JAX package (``src/repro``) is the reference; this package computes
the same functions with PyTorch on an NVIDIA GPU.  Module names mirror
the reference (``repro_torch.models.transformer`` is the counterpart of
``repro.models.transformer``, and so on) so each module's counterpart is
easy to find.  This package imports ``torch`` and never ``jax`` or
anything of ``repro``; what it needs from jax-free reference modules is
copied in.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"`` (the tests do).  Asking for CUDA on a machine without a
GPU raises; nothing falls back to the CPU.  The hand-written kernels
live in ``csrc/``: the paged flash-decoding kernel (bf16, f32 and int8
pages; bound in ``repro_torch.kernels.decode_attention``) and the Q4_0
GEMM of ``--quant q4`` (bound in ``repro_torch.kernels.q4_gemm``).
"""
