"""Earth constants (km, s, rad), the same values as the JAX package's
`dynamics/constants.py` (the standard astrodynamics set of the
reference's OD tests, hybrid_test.go:74-100).  The port keeps its own
copy: importing anything of `gokalman_tpu` imports JAX."""

GM_EARTH = 398600.4415  # km^3/s^2
R_EARTH = 6378.1363  # km
J2 = 1.082626925638815e-3
J3 = -2.5324105185677225e-6
EARTH_ROTATION_RATE = 7.292115900231276e-5  # rad/s (hybrid_test.go:100)
