"""Training and prediction operators, each kernel beside its plain
PyTorch version."""
