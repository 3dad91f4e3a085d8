"""Domain decomposition over the ranks of a ``torch.distributed`` group:
process groups and spawning (:mod:`.launch`), the sharded solver
(:mod:`.mesh`) and the multi-rank dry run (:mod:`.dryrun`)."""
