"""The port's training and evaluation steps."""
