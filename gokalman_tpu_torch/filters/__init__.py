"""Filters of the port: the vanilla CKF core, the reference's other
filters (information, square-root, SRIF, hybrid CKF/EKF, batch least
squares), the backward smoothers, and the nonlinear and ensemble tier
(UKF, SR-UKF, quadrature, EnKF / ETKF / EnKS, particle + FFBS, RBPF)."""

from . import (batch, enkf, hybrid, information, particle, quadrature, rbpf, smoothing, sqrt,
               srif, srukf, ukf, vanilla)

__all__ = ["batch", "enkf", "hybrid", "information", "particle", "quadrature", "rbpf",
           "smoothing", "sqrt", "srif", "srukf", "ukf", "vanilla"]
