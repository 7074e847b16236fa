"""Weight-only serving quantization, GPTQ style (port of ``repro/wq``).

Post-training int4 / int3 / int2 quantization of the serving stacks'
*weights*, with optional Hessian-based GPTQ error compensation, stored
packed (:class:`PackedLinear`) and dequantized inside the matmul: the
CUDA kernel K12 (``kernels/csrc/wq.cu``) for CUDA tensors, its plain
version (``kernels/ref.py::wq_matmul_ref``) for CPU tensors.
"""
from repro_torch.wq.packed import PackedLinear
from repro_torch.wq.ops import wq_matmul
from repro_torch.wq.quantize import (QUANTIZED_SUBTREES, WqConfig,
                                     gptq_quantize, packed_tree_bytes,
                                     parse_weight_quant, quantize_linear,
                                     quantize_params, quantize_tree,
                                     rtn_quantize)
from repro_torch.wq.calibrate import collect_hessians

__all__ = [
    "PackedLinear", "WqConfig", "QUANTIZED_SUBTREES", "collect_hessians",
    "gptq_quantize", "packed_tree_bytes", "parse_weight_quant",
    "quantize_linear", "quantize_params", "quantize_tree", "rtn_quantize",
    "wq_matmul",
]
