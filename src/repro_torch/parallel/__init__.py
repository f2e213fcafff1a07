"""Process groups, meshes and sharding rules on ``torch.distributed``
(``sharding``): the port of ``repro/parallel/``."""
