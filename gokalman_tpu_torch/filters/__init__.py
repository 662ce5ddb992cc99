"""Filters of the port: the vanilla CKF core with its robust and
classic variants, the reference's other filters (information,
square-root, SRIF, hybrid CKF/EKF, batch least squares), the backward
smoothers, the nonlinear and ensemble tier (UKF, SR-UKF, quadrature,
EnKF / ETKF / EnKS, particle + FFBS, RBPF), and the robust, adaptive and
mixture tier (constrained, H∞, set-membership, adaptive, Student-t,
IMM, GSF)."""

from . import (adaptive, batch, constrained, enkf, gsf, hinf, hybrid, imm, information, particle,
               quadrature, rbpf, setmembership, smoothing, sqrt, srif, srukf, studentt, ukf,
               vanilla)

__all__ = ["adaptive", "batch", "constrained", "enkf", "gsf", "hinf", "hybrid", "imm",
           "information", "particle", "quadrature", "rbpf", "setmembership", "smoothing", "sqrt",
           "srif", "srukf", "studentt", "ukf", "vanilla"]
