"""The plain references that decide a run's correct: plain PyTorch, fp32, nothing of the program."""
