from repro_torch.kernels.quant8.ops import (dequantize, dequantize_rowwise,
                                            quantize, quantize_rowwise)
