"""The fused DWFL round (the reference's ``repro.kernels.dp_mix``)."""
