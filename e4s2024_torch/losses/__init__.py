"""Training losses and the shared reconstruction criterion."""
