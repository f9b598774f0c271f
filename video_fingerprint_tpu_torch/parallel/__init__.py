"""Device lists and torch.distributed helpers: the data-parallel scan, the
corpus-sharded search and data-parallel training."""
