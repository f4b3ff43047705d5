from repro_torch.data.synthetic import classification_dataset  # noqa: F401
from repro_torch.data.partition import dirichlet_partition  # noqa: F401
from repro_torch.data.pipeline import FederatedBatcher  # noqa: F401
from repro_torch.data.device import ClassificationStore  # noqa: F401
