"""RG-LRU linear-recurrence scan: the CUDA kernel's Python wrapper.

Counterpart of the Pallas TPU kernel
``repro.kernels.rglru_scan.rglru_scan_kernel``.  The kernel itself is
``csrc/rglru_scan.cu`` (its header says what it computes, what bounds it
on an H100 and what its design does about that);
:mod:`repro_torch.kernels.build` compiles it with ``nvcc`` on first use
and loads it with ``ctypes``.  The plain version it is held against is
:func:`repro_torch.kernels.ref.rglru_scan_ref`.

:func:`rglru_scan` takes CUDA tensors only and launches the kernel or
raises: there is no fallback.  Its ``launches`` attribute is a plain
integer, one per launch, so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

KERNEL = "rglru_scan"


def _bind() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.rglru_scan
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp,          # a, u, h0, h
                       ci, ci, ci, ci,          # B, T, W, device
                       vp]                      # stream
        fn.restype = ci
        lib.rglru_scan_error.argtypes = [ci]
        lib.rglru_scan_error.restype = ctypes.c_char_p
    return lib


def rglru_scan(a: torch.Tensor, u: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h[:, t] = a[:, t] * h[:, t-1] + u[:, t] over axis 1, h[:, -1] = h0.

    a, u (B, T, W) float32 -> h (B, T, W) float32; ``h0`` (B, W) float32
    or None (zero state), folded into step 0 as the reference does.
    """
    if not a.is_cuda:
        raise ValueError("rglru_scan launches a CUDA kernel; use kernels.ref "
                         "for CPU tensors")
    if a.dim() != 3 or u.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} / u {tuple(u.shape)}: both "
                         "must be (B, T, W)")
    B, T, W = a.shape
    dev = a.device
    tensors = [("a", a), ("u", u)] + ([("h0", h0)] if h0 is not None else [])
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
    if h0 is not None and h0.shape != (B, W):
        raise ValueError(f"h0 {tuple(h0.shape)} does not fit a "
                         f"{tuple(a.shape)}")
    out = torch.empty((B, T, W), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    ac, uc = a.contiguous(), u.contiguous()
    hc = h0.contiguous() if h0 is not None else None
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rglru_scan(ac.data_ptr(), uc.data_ptr(),
                         hc.data_ptr() if hc is not None else None,
                         out.data_ptr(), B, T, W, dev.index or 0, stream)
    if err != 0:
        msg = lib.rglru_scan_error(err).decode()
        raise RuntimeError(f"rglru_scan launch failed at (B, T, W) = "
                           f"({B}, {T}, {W}): CUDA error {err} ({msg})")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
