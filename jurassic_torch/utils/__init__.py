"""Shared utilities: the nested timer stack and profiling hooks."""
from .timer import profile_trace, timed, timer

__all__ = ["profile_trace", "timed", "timer"]
