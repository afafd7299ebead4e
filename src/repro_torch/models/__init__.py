"""Dense decoder (`transformer`), attention (`attention`), building blocks
(`common`) and the `Model` facade (`registry`)."""
from repro_torch.models.registry import Model, adapter_sites, build  # noqa: F401
