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
through the kernel (a CUDA graph counts at its capture; its replays run
no Python and count nothing).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..quant.q4_0 import BLOCK
from . import build

KERNEL = "q4_gemm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of x per block of the f32 kernel (``kMT`` in the source); its
#: grid.y is at most 65535
ROWS_PER_BLOCK = 8
MAX_M = ROWS_PER_BLOCK * 65535
#: the bf16 tensor-core kernels: k per ring stage; rows of x per block
#: (8 * WM); columns per block of the prefill kernel (M > 8) and of the
#: decode kernel (M <= 8), whose 4 warps are k-groups over its columns
STAGE_K = 64
MMA_ROWS = (8, 16, 32, 64)
MMA_COLS = 128
DECODE_COLS = 32
DECODE_WARPS = 4
#: their split-K: about this many blocks per SM, at most Q4_MAX_SPLIT
#: slices (the blocks of one output tile form a cluster, whose portable
#: size is 8)
Q4_BLOCKS_PER_SM = 2
Q4_MAX_SPLIT = 8
#: what a byte of the partial tile costs against a byte of codes: it moves
#: through shared memory and the cluster, not device memory
Q4_PARTIAL_WEIGHT = 0.25


def q4_plan(M: int, K: int, N: int, sms: int):
    """(rows, n_split, sps) of the bf16 kernels: ``rows`` rows of x a block
    (the smallest compiled tile that holds M, at most 64; 8 selects the
    decode kernel), K cut into ``n_split`` slices of ``sps`` 64-k stages
    (the last one shorter).

    Cost model (``csrc/q4_gemm.cu``): a slice adds an f32 partial tile of
    rows x columns that is written to shared memory and read back across
    the cluster, worth Q4_PARTIAL_WEIGHT of as many code bytes; a stage of
    a block reads 64 x columns codes and their scales.  So a prefill slice
    holds at least the stages whose code bytes pay for its partial, a
    decode slice at least one stage for each of its 4 warps, and within
    that there are enough slices for about Q4_BLOCKS_PER_SM blocks an SM,
    at most Q4_MAX_SPLIT."""
    rows = next((r for r in MMA_ROWS if r >= M), MMA_ROWS[-1])
    cols = DECODE_COLS if rows == 8 else MMA_COLS
    stages = -(-K // STAGE_K)
    blocks = -(-N // cols) * -(-M // rows)
    if rows == 8:
        min_stages = DECODE_WARPS
    else:
        stage_bytes = STAGE_K * cols // 2 + STAGE_K // BLOCK * cols * 4
        partial = 2 * rows * cols * 4
        min_stages = max(1, math.ceil(Q4_PARTIAL_WEIGHT * partial
                                      / stage_bytes))
    want = -(-Q4_BLOCKS_PER_SM * sms // blocks)
    n_split = max(1, min(want, stages // min_stages, Q4_MAX_SPLIT))
    sps = -(-stages // n_split)
    return rows, -(-stages // sps), sps


def _bind() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.q4_gemm
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp,          # x, packed, scales, out
                       ci, ci, ci, ci,          # x_dtype, M, K, N
                       ci, ci, ci, ci,          # rows, n_split, sps, device
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

    bf16 x runs on the tensor cores with split-K (:func:`q4_plan`, kept in
    ``q4_gemm.plan``): the blocks of the K slices of one output tile form
    a cluster that sums them in a fixed order.  f32 x runs on the CUDA
    cores, exact in f32.  Either way one call is one launch.
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
    rows, n_split, sps = ROWS_PER_BLOCK, 1, 1
    if x.dtype == torch.bfloat16:
        rows, n_split, sps = q4_plan(M, K, N, build.sm_count(dev.index or 0))
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.q4_gemm(xc.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                      out.data_ptr(), _DTYPES[x.dtype], M, K, N, rows,
                      n_split, sps, dev.index or 0, stream)
    if err != 0:
        msg = lib.q4_gemm_error(err).decode()
        raise RuntimeError(f"q4_gemm launch failed at (M, K, N) = "
                           f"({M}, {K}, {N}): CUDA error {err} ({msg})")
    q4_gemm.launches += 1
    q4_gemm.plan = (rows, n_split, sps)
    return out


q4_gemm.launches = 0
#: (rows, n_split, sps) of the last launch
q4_gemm.plan = None
