"""Hand-written CUDA kernels for Hopper (``csrc/``), built by ``build.py``.

The Python wrappers that launch them, with their plain PyTorch versions
and launch counters, live beside the code that calls them
(``tpu_operator_torch.payload.flash_attention``).
"""
