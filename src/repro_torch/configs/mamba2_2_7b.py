"""mamba2-2.7b [ssm] — SSD, state-space duality (arXiv:2405.21060).

64L d_model=2560 (attention-free) vocab=50280, ssm_state=128, expand=2,
head_dim=64 (=> 80 heads). FourierFT targets the in/out projections
(wx / wo_ssm): the architecture has no attention, so the paper's q/v
default does not apply (`models.registry.resolve_default_targets`).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state=128, head_dim=64, expand=2, n_groups=1),
    subquadratic=True,
)
