# Hand-written Hopper kernels replacing the reference's Pallas TPU kernels.
# Each subpackage: kernel.py (CUDA binding + launch counter), ops.py
# (dispatch: kernel for CUDA tensors, plain version for CPU tensors or
# impl="ref"), ref.py (plain PyTorch oracle), csrc/ (CUDA sources).
#
#   fed_agg         -- K-way weighted model aggregation (the FLight merge)
#
# Still to port (ROADMAP queue 2): quant8, flash_attention, linrec.
