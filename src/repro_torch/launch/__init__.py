"""Command-line entry points of the port: ``python -m repro_torch.launch.train``
(fit a NOMAD workload on one card, with checkpoints, crash and resume),
``python -m repro_torch.launch.distributed`` (the sharded fit, one process
a card over ``torch.distributed``, ``mesh.py`` its meshes of shard slots)
and ``python -m repro_torch.launch.dryrun`` (a step's cost and memory on
meta tensors, against the H100's peaks)."""
