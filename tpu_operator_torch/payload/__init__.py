"""The PyTorch payload: the serve path (``serve`` -> ``kvcache`` ->
``models`` -> ``flash_attention``), training (``transformer``, ``cifar``,
``linear`` -> ``train``), and the runtime the operator talks to
(``bootstrap``, ``heartbeat``, ``steptrace``, ``checkpoint``, ``startup``,
``warmstore`` and ``store``, ``autotune``, ``profile``). Each module
mirrors its namesake in ``tpu_operator.payload`` (``store`` mirrors
``tpu_operator.store``)."""
