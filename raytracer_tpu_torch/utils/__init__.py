"""Coordinates and result export."""
