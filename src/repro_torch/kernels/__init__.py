# Hand-written Hopper kernels replacing the reference's Pallas TPU kernels.
# Each subpackage: kernel.py (CUDA binding + launch counter), ops.py
# (dispatch: kernel for CUDA tensors, plain version for CPU tensors or
# impl="ref"), ref.py (plain PyTorch oracle), csrc/ (CUDA sources).
#
#   fed_agg         -- K-way weighted model aggregation (the FLight merge)
#   quant8          -- symmetric int8 quantise / dequantise, one fp32 scale
#                      per row (the compressed island exchange, int8 KV caches)
#   flash_attention -- causal / sliding-window GQA attention forward, fp32
#                      online softmax (every LM prefill layer)
#
# Still to port (ROADMAP queue 2): linrec.
