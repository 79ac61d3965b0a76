"""PyTorch + CUDA port of the tpu_operator payload, for NVIDIA Hopper.

The JAX package (``tpu_operator``) is the reference; this package mirrors
its payload modules one for one (``tpu_operator_torch.payload.<module>``)
and replaces each Pallas TPU kernel with a CUDA kernel written for
``sm_90a`` (``tpu_operator_torch.kernels``). It imports nothing of JAX and
nothing of ``tpu_operator``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; see :func:`tpu_operator_torch.device.resolve_device`.
"""

VERSION = "0.1.0"
