"""Models of the port: the paper's MLP classifier and the dense
transformer of the dense and vlm LM families."""
