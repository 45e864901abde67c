"""Training utilities: model EMA and LR schedules."""
