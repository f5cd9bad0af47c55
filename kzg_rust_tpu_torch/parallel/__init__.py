"""Multi-device scale-out: :mod:`.sharded` splits the point, domain and blob
axes over the cards of one process; :mod:`.distributed` adds ranks joined
by ``torch.distributed``."""
