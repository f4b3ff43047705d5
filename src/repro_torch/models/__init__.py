"""Models of the port: the paper's MLP classifier, the dense transformer
of the dense and vlm LM families, and the Mamba2 hybrid (zamba2)."""
