"""Model step: device operations (kernels and copies) launched inside
the benchmark's decode range (one ``ModelRunner.decode`` call), per call
that launched any, over the traced slice.  The count a CUDA graph of the
decode step would collapse."""

from . import owned_ops


def read(run):
    counts = [len(ops) for ops in owned_ops(run, "decode").values() if ops]
    return sum(counts) / len(counts) if counts else None
