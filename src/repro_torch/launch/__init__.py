"""Launch layer of the port: the serving mesh (``mesh.py``) and the
placement rules of the serving state (``sharding.py``).

The reference's LM modules (``steps``, ``train``, ``serve``, ``dryrun``,
``roofline``, ``hlo_analysis``) and the LM part of its ``sharding.py``
belong to the LM scaffold, which is not ported yet."""
