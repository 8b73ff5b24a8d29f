"""Multi-device training: the mesh's sharding rules, ZeRO-2 state
(``sharding.py``) and the tensor-parallel collectives (``tp.py``)."""
