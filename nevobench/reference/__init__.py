"""Plain PyTorch references of the benchmark's models and preprocessing; they import nothing of the program."""
