"""Several devices: the data-parallel mesh (``mesh``), the aligner's route
over it (``pipeline``), the idx-sharded FM steps (``dataparallel``), several
processes joined by ``torch.distributed`` (``distributed``) and the
multi-device dry run (``dryrun``); the counterparts of bwamem_tpu/parallel/
and of __graft_entry__.py ``dryrun_multichip``."""
