"""Numerics shared by the backends: W8A8 quantization."""
