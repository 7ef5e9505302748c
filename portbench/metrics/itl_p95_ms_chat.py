"""95th percentile of the gap between consecutive output tokens in the
open-loop chat cell: the same arithmetic as the end-to-end ``itl_p95_ms``,
reported per layer there because host stalls spread it too widely across
runs for an end-to-end bound (PERF.md, section 6)."""

from .itl_p95_ms import read  # noqa: F401
