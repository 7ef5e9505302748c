"""Kernels: share of its roofline that kernel #1 (the paged
decode-attention, ``csrc/paged_decode_attention.cu``: its split and merge
launches) reaches in the decode steps of the traced slice: the least time
of each call (``portbench.counts.paged_attn_least`` over the call's lanes:
each request's context from the benchmark's own records, a shared prefix
counted once) over the kernel's device time in that call, summed over
calls."""

import bisect

from ..counts import least_seconds, paged_attn_least
from . import owned_ops

KERNELS = ("paged_split_kernel", "paged_merge_kernel")


def lanes_by_call(run):
    """{decode call index: [(kv_len, group, shared_len)]}: each decode
    token the benchmark stamped, placed in the last decode call that
    returned before its stamp (a step publishes its tokens after its
    forward)."""
    decodes = [c for c in run.calls if c.kind == "decode"]
    exits = [c.t_exit for c in decodes]
    out = {}
    for r in run.records:
        for k in range(1, len(r.stamps)):
            j = bisect.bisect_right(exits, r.stamps[k]) - 1
            if j >= 0:
                out.setdefault(decodes[j].index, []).append(
                    (len(r.req.prompt) + k, r.req.group, r.req.shared_len))
    return out


def read(run):
    calls = owned_ops(run, "decode")
    if not calls:
        return None
    lanes = lanes_by_call(run)
    least = spent = 0.0
    for i, ops in calls.items():
        ns = sum(op.end - op.start for op in ops
                 if any(k in op.name for k in KERNELS))
        if ns and lanes.get(i):
            least += least_seconds(*paged_attn_least(run.cfg, lanes[i]))
            spent += ns * 1e-9
    return 100.0 * least / spent if spent else None
