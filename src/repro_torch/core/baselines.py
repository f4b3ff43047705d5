"""The baselines the paper compares against (Figs. 5-6): a facade over
``repro_torch.core.dwfl``, as the reference's ``repro.core.baselines`` is.
Select them with ProtocolConfig(scheme="orthogonal" | "centralized")."""
from repro_torch.core.dwfl import (  # noqa: F401
    exchange_centralized,
    exchange_orthogonal,
)
from repro_torch.core.privacy import epsilon_orthogonal  # noqa: F401
