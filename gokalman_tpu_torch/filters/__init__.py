"""Filters of the port: the vanilla CKF core with its robust and
classic variants, the reference's other filters (information,
square-root, SRIF, hybrid CKF/EKF, batch least squares), the backward
smoothers, the nonlinear and ensemble tier (UKF, SR-UKF, quadrature,
EnKF / ETKF / EnKS, particle + FFBS, RBPF), the robust, adaptive and
mixture tier (constrained, H∞, set-membership, adaptive, Student-t,
IMM, GSF), the attitude and navigation tier (MEKF / USQUE, the SE_2(3)
invariant EKF and its RTS smoother) and the factored and
optimization-based filters (U-D, SISE, Schmidt consider, MHE)."""

from . import (adaptive, batch, constrained, enkf, gsf, hinf, hybrid, iekf, imm, information,
               mekf, mhe, particle, quadrature, rbpf, schmidt, setmembership, sise, smoothing,
               sqrt, srif, srukf, studentt, udu, ukf, vanilla)

__all__ = ["adaptive", "batch", "constrained", "enkf", "gsf", "hinf", "hybrid", "iekf", "imm",
           "information", "mekf", "mhe", "particle", "quadrature", "rbpf", "schmidt",
           "setmembership", "sise", "smoothing", "sqrt", "srif", "srukf", "studentt", "udu",
           "ukf", "vanilla"]
