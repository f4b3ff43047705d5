"""The fused local step with DP noise (the reference's
``repro.kernels.dp_perturb``)."""
