"""The plain reference: models, the served clip and the train step, in plain
PyTorch and fp32.  It imports nothing of the measured program."""
