"""Training: the optimizer, gradient compression and the restartable
train loop."""
