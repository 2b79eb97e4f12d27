"""The plain float32 reference that decides a run's `correct`: the model,
the eval tail and the train step, in plain PyTorch, independent of the
program under test."""
