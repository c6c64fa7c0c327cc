"""Plain references: independent PyTorch or NumPy code that works out
again, from the inputs the benchmark made, what the program must
produce.  Nothing here imports the program."""
