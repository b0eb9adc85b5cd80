"""FSDP x TP sharding rules over a ``DeviceMesh`` (``rules.py``)."""
