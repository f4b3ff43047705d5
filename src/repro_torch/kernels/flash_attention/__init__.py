"""Causal streaming-softmax attention (the reference's
``repro.kernels.flash_attention``)."""
