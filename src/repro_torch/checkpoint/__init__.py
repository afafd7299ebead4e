"""Train-state checkpoints (`manager`) and portable adapter-only exports
(`adapters`), both in the JAX package's on-disk formats."""
