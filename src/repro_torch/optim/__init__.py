from repro_torch.optim.optimizers import Optimizer, adam, momentum, sgd  # noqa: F401
