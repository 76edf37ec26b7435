"""Serving (``train.server``) and training (``train.trainer``)."""
