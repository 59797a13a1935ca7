"""Host mesh and velocity builders (NumPy)."""
