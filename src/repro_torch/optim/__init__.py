"""Optimizers over dict-of-tensor parameters (sgd, momentum, adam, adamw)."""
