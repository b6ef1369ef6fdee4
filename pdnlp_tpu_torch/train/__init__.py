"""Single-device training: setup, steps, the Trainer, the optimizer and the
port's own checkpoint format."""
