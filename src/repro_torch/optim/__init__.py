"""Optimizers: Adam/AdamW, its Q8 twin and the learning-rate schedules."""
