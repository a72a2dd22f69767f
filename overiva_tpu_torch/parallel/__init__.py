"""The multi-device tier: a ('mix', 'bins') ``torch.distributed`` mesh
(:mod:`.mesh`), the bin- and batch-sharded families (:mod:`.sharded`),
the rank launcher (:mod:`.launch`) and the dry run (:mod:`.dryrun`)."""
