"""Launch layer of the port: the serving mesh (``mesh.py``), the placement
rules of the serving state and the LM's parameter, batch and cache specs
(``sharding.py``), the step builders (``steps.py``), the training driver
(``train.py``) and the serving driver (``serve.py``: ``FusedFeatureServer``
and ``run_serving``, which feeds the fused features into an LM and
decodes).

The reference's analysis modules (``dryrun``, ``roofline``,
``hlo_analysis``) are not ported yet."""
