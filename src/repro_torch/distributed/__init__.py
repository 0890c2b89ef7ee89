"""The distributed layer of the port on ``torch.distributed``: the
current mesh and activation hints (``hints``), the sharding rules
(``sharding``) and the pod-level stage pipeline (``pipeline``)."""
