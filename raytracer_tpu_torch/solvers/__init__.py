"""Solver API, result types and ray paths."""
