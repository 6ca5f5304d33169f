"""Losses of the train and eval steps (forward; the optimizer and Trainer come later)."""
