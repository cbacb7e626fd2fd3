"""Training: the step, the epoch loop, checkpoints and ``fit``."""
