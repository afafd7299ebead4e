"""The merged train step (`step`) and the fault-tolerant loop (`loop`)."""
