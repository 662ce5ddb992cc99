"""Filters of the port: the vanilla CKF core, the reference's other
filters (information, square-root, SRIF, hybrid CKF/EKF, batch least
squares) and the backward smoothers."""

from . import batch, hybrid, information, smoothing, sqrt, srif, vanilla

__all__ = ["batch", "hybrid", "information", "smoothing", "sqrt", "srif", "vanilla"]
