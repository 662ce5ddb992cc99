"""Filters of the port: the vanilla CKF core with its robust and
classic variants, the reference's other filters (information,
square-root, SRIF, hybrid CKF/EKF, batch least squares), the backward
smoothers, the nonlinear and ensemble tier (UKF, SR-UKF, quadrature,
EnKF / ETKF / EnKS, particle + FFBS, RBPF), the robust, adaptive and
mixture tier (constrained, H∞, set-membership, adaptive, Student-t,
IMM, GSF), the attitude and navigation tier (MEKF / USQUE, the SE_2(3)
invariant EKF and its RTS smoother), the factored and
optimization-based filters (U-D, SISE, Schmidt consider, MHE), and the
association trackers and unlabelled random-finite-set filters (PDAF,
JPDA, the GNN tracker, GM-PHD, GM-CPHD, PMB) with track-to-track
fusion, and the labelled filters (LMB, δ-GLMB)."""

from . import (adaptive, batch, constrained, cphd, enkf, fusion, glmb, gsf, hinf, hybrid, iekf,
               imm, information, jpda, lmb, mekf, mhe, particle, pdaf, phd, pmb, quadrature, rbpf,
               schmidt, setmembership, sise, smoothing, sqrt, srif, srukf, studentt, tracker, udu,
               ukf, vanilla)

__all__ = ["adaptive", "batch", "constrained", "cphd", "enkf", "fusion", "glmb", "gsf", "hinf",
           "hybrid", "iekf", "imm", "information", "jpda", "lmb", "mekf", "mhe", "particle",
           "pdaf", "phd", "pmb", "quadrature", "rbpf", "schmidt", "setmembership", "sise",
           "smoothing", "sqrt", "srif", "srukf", "studentt", "tracker", "udu", "ukf", "vanilla"]
