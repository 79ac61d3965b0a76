"""The PyTorch payload: the serve path (``serve`` -> ``kvcache`` ->
``models`` -> ``flash_attention``) with its bootstrap, heartbeat and step
recorder. Each module mirrors its namesake in ``tpu_operator.payload``."""
