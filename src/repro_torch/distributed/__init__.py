"""repro_torch.distributed - the manual collectives on torch.distributed
(port of ``repro.distributed``: ``collectives``). The trainer's sharding
rules, pipeline parallelism and elastic restarts (``sharding``,
``pipeline_parallel``, ``elastic``) wait for ROADMAP.md A.7b."""
from repro_torch.distributed import collectives
