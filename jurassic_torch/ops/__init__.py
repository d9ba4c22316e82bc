"""Operators of the port: continua, turbo tables and the fused EGA pass."""
