"""The JAX package's four examples on the port, each run as
`python -m repro_torch.examples.<name>` (on the card unless `--device`
says otherwise): `quickstart`, `serve_batched`, `train_peft_100m` and
`expressiveness_2d`. Same configs, methods, step counts and printed lines
as `examples/*.py`; `--steps` cuts the run."""
