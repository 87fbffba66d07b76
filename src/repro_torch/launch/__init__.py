"""Launch layer of the port: the serving mesh (``mesh.py``), the placement
rules of the serving state (``sharding.py``) and the serving driver
(``serve.py``: ``FusedFeatureServer`` and ``run_serving``, which feeds the
fused features into an LM and decodes).

The reference's training and analysis modules (``steps``, ``train``,
``dryrun``, ``roofline``, ``hlo_analysis``) and the LM part of its
``sharding.py`` are not ported yet."""
