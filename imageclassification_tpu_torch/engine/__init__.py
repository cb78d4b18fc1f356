"""Train state, train and eval steps, and the epoch loops."""
