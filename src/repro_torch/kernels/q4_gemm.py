"""Q4_0 dequantize + matmul: the CUDA kernel's Python wrapper.

Counterpart of the Pallas TPU kernel ``repro.kernels.q4_gemm.q4_gemm``.
The kernel itself is ``csrc/q4_gemm.cu`` (its header says what it
computes, what bounds it on an H100 and what its design does about
that); :mod:`repro_torch.kernels.build` compiles it with ``nvcc`` on
first use and loads it with ``ctypes``.  The plain version it is held
against is :func:`repro_torch.kernels.ref.q4_gemm_ref`.

:func:`q4_gemm` takes CUDA tensors only and launches the kernel or
raises: there is no fallback.  Its ``launches`` attribute is a plain
integer, one per launch, so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.q4_0 import BLOCK
from . import build

KERNEL = "q4_gemm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of x per block (``kMT`` in the source); grid.y is at most 65535
ROWS_PER_BLOCK = 8
MAX_M = ROWS_PER_BLOCK * 65535


def _bind() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.q4_gemm
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp,          # x, packed, scales, out
                       ci, ci, ci, ci, ci,      # x_dtype, M, K, N, device
                       vp]                      # stream
        fn.restype = ci
        lib.q4_gemm_error.argtypes = [ci]
        lib.q4_gemm_error.restype = ctypes.c_char_p
    return lib


def q4_gemm(x: torch.Tensor, packed: torch.Tensor,
            scales: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(packed (K/2, N) uint8, scales (K/32, N) f32)
    -> (M, N) in x.dtype.

    x is float32 or bfloat16 (the kernel sums in float32 and rounds the
    result to x's type).  K must be a multiple of 32 (``make_qmm`` pads
    to the block) and N a multiple of 4; any M up to 524,280.
    """
    if not x.is_cuda:
        raise ValueError("q4_gemm launches a CUDA kernel; use kernels.ref "
                         "for CPU tensors")
    dev = x.device
    for name, t in (("packed", packed), ("scales", scales)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"packed must be uint8 and scales float32 (got "
                        f"{packed.dtype}, {scales.dtype})")
    if x.dim() != 2 or packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)}, packed {tuple(packed.shape)}"
                         f", scales {tuple(scales.shape)}: all must be 2-D")
    M, K = x.shape
    K2, N = packed.shape
    if K != 2 * K2 or scales.shape != (K // BLOCK, N):
        raise ValueError(f"x {tuple(x.shape)} does not fit packed "
                         f"{tuple(packed.shape)} / scales "
                         f"{tuple(scales.shape)}")
    if K % BLOCK or N % 4 or M > MAX_M:
        raise ValueError(f"q4_gemm takes K % {BLOCK} == 0, N % 4 == 0 and "
                         f"M <= {MAX_M}; got (M, K, N) = ({M}, {K}, {N})")
    if not (packed.is_contiguous() and scales.is_contiguous()) \
            or packed.data_ptr() % 4 or scales.data_ptr() % 16:
        raise ValueError("packed and scales must be contiguous, packed "
                         "4-byte and scales 16-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0 or N == 0:
        return out
    xc = x.contiguous()
    if xc.data_ptr() % 16:         # the kernel reads x 16 bytes at a time
        xc = xc.clone()
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.q4_gemm(xc.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                      out.data_ptr(), _DTYPES[x.dtype], M, K, N,
                      dev.index or 0, stream)
    if err != 0:
        msg = lib.q4_gemm_error(err).decode()
        raise RuntimeError(f"q4_gemm launch failed at (M, K, N) = "
                           f"({M}, {K}, {N}): CUDA error {err} ({msg})")
    q4_gemm.launches += 1
    return out


q4_gemm.launches = 0
