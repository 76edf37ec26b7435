"""Model substrate: the dense and SSM families as plain functions on
dicts of tensors, with the JAX package's parameter names and layouts.

``model.build(config)`` returns a ``Model`` with ``init`` / ``forward`` /
``prefill`` / ``decode`` / ``init_cache``; ``train/server.py`` builds the
greedy serve step on top of it.
"""
