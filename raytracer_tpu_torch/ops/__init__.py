"""Kernels, tables and the sweep solver of the PyTorch port."""
