"""Eval step (the train step comes with the training slice)."""
