from repro_torch.data.synthetic import classification_dataset, lm_dataset  # noqa: F401
from repro_torch.data.partition import dirichlet_partition, iid_partition  # noqa: F401
from repro_torch.data.pipeline import FederatedBatcher, LMBatcher  # noqa: F401
from repro_torch.data.device import (ClassificationStore, LMStore,  # noqa: F401
                                     store_from_batcher)
