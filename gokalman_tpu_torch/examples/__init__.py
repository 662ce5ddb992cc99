"""The repository's twelve `examples/*.py` scripts on the port.

One module per script, each with `main(outdir=None, device=None,
**sizes)`: it runs the script's scenario through the port, prints what
the script prints, asserts what the script asserts, and returns a dict
of the quantities it claims, with their rows under "claims" (a
`_common.Claims`: label, value and bound, or the printed gate where the
script asserts nothing).  The sizes default to the script's own; the
tests pass smaller ones.  Files are written only when `outdir` is
given.  Each runs as `python -m gokalman_tpu_torch.examples.<name>
[outdir]`, on the card unless `--cpu` is given.

Inputs that the scripts draw with numpy are drawn the same way, bit for
bit.  Draws the scripts make with `jax.random` come from a host
`torch.Generator` seeded with the script's integer and are moved to the
device, so a scenario is the same on the card and on the CPU (the
δ-GLMB takes the Philox key of `glmb.run`, which draws the same on
both).  Each module also takes such draws as arguments, so the tests
can hand it JAX's own.
"""

NAMES = ("robot", "statod", "jerkcar", "multitarget", "filter_tuning", "robust_estimation",
         "maneuvering_target", "orbit_determination", "attitude", "navigation",
         "sensor_network", "tracking")
