"""repro_torch.distributed - the port of ``repro.distributed`` on
torch.distributed: the manual collectives (``collectives``), the trainer's
DP x TP x ZeRO sharding rules and state on DTensor (``sharding``),
pipeline parallelism (``pipeline_parallel``) and elastic restarts
(``elastic``)."""
from repro_torch.distributed import collectives, sharding
