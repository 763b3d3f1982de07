"""Numerical building blocks and the fused-kernel tier."""
