"""Step-keyed synthetic data (`synthetic`)."""
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticClassification, SyntheticLM,
)
