"""Mamba2 SSD chunked scan (the reference's ``repro.kernels.ssd_scan``)."""
