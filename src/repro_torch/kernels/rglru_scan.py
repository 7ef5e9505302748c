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
through the kernel; its ``plan`` attribute is the last launch's
:func:`scan_plan`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

KERNEL = "rglru_scan"
#: channels a warp owns (one batch row), and bytes of a and u one step of
#: them costs in a ring tile
LANES = 32
STEP_BYTES = 2 * LANES * 4
#: steps a ring stage holds (compiled: ``STEPS`` in the source), the most
#: stages a ring has and the most warps a block has (``kMaxStages``,
#: ``kMaxWarps``)
SCAN_STEPS = (8, 16, 32, 64)
SCAN_MAX_STAGES = 16
SCAN_MAX_WARPS = 4
#: bytes of a and u the grid's rings keep in flight together: a few times
#: the card's latency-bandwidth product (3.35 TB/s x ~0.7 us = 2.3 MB)
SCAN_INFLIGHT_BYTES = 6 << 20
#: blocks an SM should get at least before a block holds more than one warp
SCAN_BLOCKS_PER_SM = 2
#: shared memory a block may use, an SM holds, and the SM keeps per block
SMEM_PER_BLOCK = 227 * 1024
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024


def scan_smem(warps_per_block: int, steps: int, stages: int) -> int:
    """Dynamic shared memory of one block (``warp_smem`` in the source): a
    warp's ring of ``stages`` a and u tiles, two h tiles and a barrier a
    stage, in 128-byte units, plus 128 bytes to align the first."""
    warp = ((2 * stages + 2) * steps * LANES * 4 + 8 * stages + 127) \
        // 128 * 128
    return 128 + warps_per_block * warp


def scan_plan(B: int, T: int, W: int, sms: int):
    """(warps_per_block, steps_per_stage, stages) of the scan kernel.

    A warp owns 32 channels of one batch row and streams a and u through
    its own ring of ``stages`` tiles of ``steps_per_stage`` steps
    (``STEP_BYTES`` a step), ``stages - 1`` of them in flight while it
    computes the oldest (``csrc/rglru_scan.cu``).  So each warp should keep
    its share of SCAN_INFLIGHT_BYTES in flight, no more than T steps: the
    stage is the largest that still leaves two of them in flight (a
    stage's copies, waits and store cost the warp's chain the same at any
    length), the ring as deep as that share needs.  Blocks hold one warp
    until the grid has
    SCAN_BLOCKS_PER_SM blocks an SM, so the warps spread over every SM.
    The ring is made shallower, then its stages shorter, until the blocks
    an SM must hold for one wave fit its shared memory.  Plain Python: it
    reads nothing on the device."""
    strips = -(-W // LANES)
    warps = max(1, B * strips)
    wpb = next((n for n in (4, 2, 1) if n <= SCAN_MAX_WARPS
                and -(-warps // n) >= SCAN_BLOCKS_PER_SM * sms), 1)
    blocks = -(-warps // wpb)
    per_sm = -(-blocks // sms)                  # blocks an SM holds
    want = max(1, min(T, -(-SCAN_INFLIGHT_BYTES // (warps * STEP_BYTES))))
    steps = max((s for s in SCAN_STEPS if 2 * s <= want),
                default=SCAN_STEPS[0])
    stages = max(2, min(SCAN_MAX_STAGES, -(-want // steps) + 1,
                        -(-T // steps) + 1))

    def fits(st, s):
        block = scan_smem(wpb, s, st)
        return (block <= SMEM_PER_BLOCK and
                per_sm * (block + SMEM_RESERVED_PER_BLOCK) <= SMEM_PER_SM)

    while stages > 2 and not fits(stages, steps):
        stages -= 1
    while steps > SCAN_STEPS[0] and not fits(stages, steps):
        steps = SCAN_STEPS[SCAN_STEPS.index(steps) - 1]
    return wpb, steps, stages


def _bind() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.rglru_scan
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp,          # a, u, h0, h
                       ci, ci, ci,              # B, T, W
                       ci, ci, ci,              # the plan
                       ci, vp]                  # device, stream
        fn.restype = ci
        lib.rglru_scan_error.argtypes = [ci]
        lib.rglru_scan_error.restype = ctypes.c_char_p
    return lib


def rglru_scan(a: torch.Tensor, u: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h[:, t] = a[:, t] * h[:, t-1] + u[:, t] over axis 1, h[:, -1] = h0.

    a, u (B, T, W) float32 -> h (B, T, W) float32; ``h0`` (B, W) float32
    or None (zero state), folded into step 0 as the reference does.

    One launch, planned by :func:`scan_plan` (kept in ``rglru_scan.plan``).
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
    plan = scan_plan(B, T, W, build.sm_count(dev.index or 0))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rglru_scan(ac.data_ptr(), uc.data_ptr(),
                         hc.data_ptr() if hc is not None else None,
                         out.data_ptr(), B, T, W, *plan, dev.index or 0,
                         stream)
    if err != 0:
        msg = lib.rglru_scan_error(err).decode()
        raise RuntimeError(f"rglru_scan launch failed at (B, T, W) = "
                           f"({B}, {T}, {W}): CUDA error {err} ({msg})")
    rglru_scan.launches += 1
    rglru_scan.plan = plan
    return out


rglru_scan.launches = 0
rglru_scan.plan = None
