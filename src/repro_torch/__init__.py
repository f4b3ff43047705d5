"""PyTorch/CUDA port of the DWFL reproduction (``repro``).

The package mirrors ``repro``'s layout (configs, core, data, models,
kernels, launch) and imports torch and numpy only — never jax, never
``repro``. Entry points take a ``device`` argument that defaults to
"cuda" and raise when no card is present (``runtime.resolve_device``);
the CPU is used only when the caller asks for it.
"""
