"""Device: the decode steps' share of the bf16 peak (989 TFLOP/s): the
model FLOPs of every decode token stamped in the window
(``portbench.counts.decode_token_flops`` at its own context length) over
the program's decode-phase wall in the window (``serving.phase.decode_s``)
times the peak."""

from ..counts import PEAK_BF16_FLOPS, decode_token_flops
from . import decode_tokens, delta


def read(run):
    wall = delta(run, "decode_s")
    if not wall:
        return None
    flops = sum(decode_token_flops(run.cfg, len(r.req.prompt) + k)
                for r, k, _ in decode_tokens(run, run.t_w0, run.t_w1))
    return 100.0 * flops / (wall * PEAK_BF16_FLOPS)
