"""Dynamics of the port of gokalman_tpu/dynamics: orbital dynamics (the
`smd` dependency of the reference's OD tests, SURVEY.md §2.16: two-body
+ J2/J3 gravity, fixed-step RK integrators with the STM by forward-mode
AD of the flow, orbital-element <-> RV conversions, ground stations
with range/range-rate measurements and elevation-mask visibility, and
Earth rotation), quaternion attitude kinematics (`attitude`) and the
SO(3) / SE_2(3) Lie groups (`liegroup`).  Everything works on leading
batch dims.
"""

from . import attitude, constants, elements, gravity, integrators, liegroup, propagate, stations

__all__ = ["attitude", "constants", "elements", "gravity", "integrators", "liegroup",
           "propagate", "stations"]
