from repro_torch.quant.quantize import (DEFAULT_GROUP, PACK_FACTOR, QMAX, QTensor,
                                       dequantize, expert_nbytes, pack_codes,
                                       quantization_error, quantize, quantize_tree,
                                       unpack_codes)

__all__ = ["DEFAULT_GROUP", "PACK_FACTOR", "QMAX", "QTensor", "dequantize",
           "expert_nbytes", "pack_codes", "quantization_error", "quantize",
           "quantize_tree", "unpack_codes"]
