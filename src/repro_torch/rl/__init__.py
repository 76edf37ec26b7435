"""LandmarkNav, the MLP policy and the batched trajectory sampler."""
