# Hand-written Hopper kernels replacing the reference's Pallas TPU kernels.
# Each subpackage: kernel.py (CUDA binding + launch counter), ops.py
# (dispatch: kernel for CUDA tensors, plain version for CPU tensors or
# impl="ref"), ref.py (plain PyTorch oracle), csrc/ (CUDA sources).
#
#   fed_agg         -- K-way weighted model aggregation (the FLight merge)
#   quant8          -- symmetric int8 quantise / dequantise, one fp32 scale
#                      per row (the compressed island exchange, int8 KV caches)
#   flash_attention -- causal / sliding-window GQA attention forward, fp32
#                      online softmax (every LM prefill layer); and the
#                      training pair: the forward with its row
#                      log-sum-exp and a backward (dq; dk and dv) for
#                      self attention that carries a gradient
#   linrec          -- diagonal linear recurrence h_t = a_t h_{t-1} + b_t
#                      from a starting state (the SSM and RG-LRU scans, in
#                      prefill and decode)
#
# Every Pallas TPU kernel of the reference now has its counterpart here.
