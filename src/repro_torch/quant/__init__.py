from repro_torch.quant.quantize import (DEFAULT_GROUP, PACK_FACTOR, QMAX, QTensor,
                                       dequantize, expert_nbytes, pack_codes,
                                       quantize, unpack_codes)

__all__ = ["DEFAULT_GROUP", "PACK_FACTOR", "QMAX", "QTensor", "dequantize",
           "expert_nbytes", "pack_codes", "quantize", "unpack_codes"]
