"""Runnable examples of the port: the counterparts of ``examples/*.py``.

Each is a module run as ``python -m msgwam_tpu_torch.examples.<name>``,
with the JAX example's module-level sizes and functions:

* :mod:`.megakernel_day` — a simulated day of 1e6 coupled ray volumes
  through the whole-run kernel K5, ten launches;
* :mod:`.config_ladder` — the BASELINE configs 1, 2 and 5 (the ensemble
  through K7 on the card);
* :mod:`.critical_level_relaunch` — a tidal shear with critical-level
  culling and relaunch, the flux history streamed to disk;
* :mod:`.reference_experiment` — the reference's own experiment written
  against the drop-in ``libprop`` shim (:mod:`msgwam_tpu_torch.api`);
* :mod:`.source_inversion` — a source spectrum recovered by gradient
  descent through the coupled simulation.

Every example runs on the card unless ``--device`` names another device
(``--device cpu`` runs the plain paths and the kernels' twins), and
imports matplotlib only when asked for a figure (``--plot``).
"""
