"""Device resolution and dict-of-tensor helpers."""
