"""Distribution: logical sharding rules over a ``DeviceMesh`` (the port of
``repro/distributed``)."""
