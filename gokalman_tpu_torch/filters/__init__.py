"""Filters of the port; this slice holds the vanilla CKF core."""

from . import vanilla

__all__ = ["vanilla"]
