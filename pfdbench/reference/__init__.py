"""The benchmark's plain reference: float32 PyTorch and NumPy, independent of
the program under test (it imports nothing of it, nor JAX)."""
