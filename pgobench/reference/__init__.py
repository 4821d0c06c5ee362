"""The plain float64 reference of the benchmark (NumPy only): it imports
nothing of the program under test."""
