"""Launch layer of the port: the serving mesh and the LM's ``DeviceMesh``
(``mesh.py``), the placement rules of the serving state and the LM's
parameter, batch and cache specs and their DTensor placements
(``sharding.py``), the step functions and the dry run's shaped inputs
(``steps.py``), training (``train.py``), serving (``serve.py``:
``FusedFeatureServer`` and ``run_serving``, which feeds the fused features
into an LM and decodes), and the dry run: the per-device cost analyzer of
an eager step (``hlo_analysis.py``), the H100 roofline (``roofline.py``)
and the command over every (arch × shape × mesh) cell (``dryrun.py``)."""
