"""The paper's experiment settings."""
