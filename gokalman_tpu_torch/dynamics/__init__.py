"""Orbital dynamics, the port of gokalman_tpu/dynamics (the `smd`
dependency of the reference's OD tests, SURVEY.md §2.16): two-body +
J2/J3 gravity, fixed-step RK integrators with the STM by forward-mode
AD of the flow, orbital-element <-> RV conversions, ground stations
with range/range-rate measurements and elevation-mask visibility, and
Earth rotation.  Everything works on leading batch dims.  The attitude
and Lie-group modules are not ported yet.
"""

from . import constants, elements, gravity, integrators, propagate, stations

__all__ = ["constants", "elements", "gravity", "integrators", "propagate", "stations"]
