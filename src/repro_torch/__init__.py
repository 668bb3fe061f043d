"""FLight in PyTorch for NVIDIA Hopper: the port of `repro` (JAX/TPU).

The subpackages mirror `repro`'s names (configs, core, data, kernels,
launch, models, examples).  Nothing here imports jax or `repro`: framework-free
modules are copied and held equal to their originals by the tests.

Entry points run on CUDA unless the caller passes ``device="cpu"``; see
`repro_torch.runtime.resolve_device`.
"""
