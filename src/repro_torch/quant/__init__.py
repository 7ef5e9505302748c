"""repro_torch.quant: Q4_0 weights, int8 KV pages, serving policy
(``repro.quant``)."""

from .kv_int8 import dequantize_rows, kv_bytes_per_row_head, quantize_rows
from .policy import (Q4_WEIGHT_NAMES, QuantPolicy, count_q4_leaves,
                     is_q4_leaf, make_qmm, param_bytes,
                     quantize_serving_params)
from .q4_0 import (BLOCK, BYTES_PER_WEIGHT, dequantize, padded_k, quantize,
                   quantize_params, quantize_stacked, quantized_bytes,
                   unpack_codes)

__all__ = [
    "BLOCK", "BYTES_PER_WEIGHT", "Q4_WEIGHT_NAMES", "QuantPolicy",
    "count_q4_leaves", "dequantize", "dequantize_rows", "is_q4_leaf",
    "kv_bytes_per_row_head", "make_qmm", "padded_k", "param_bytes",
    "quantize", "quantize_params", "quantize_rows",
    "quantize_serving_params",
    "quantize_stacked", "quantized_bytes", "unpack_codes",
]
