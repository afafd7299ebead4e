"""AdamW (`adamw`) and learning-rate schedules (`schedules`)."""
from repro_torch.optim import adamw, schedules  # noqa: F401
