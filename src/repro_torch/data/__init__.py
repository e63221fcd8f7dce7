"""Host data of the port: synthetic streams and the prefetch pipeline."""
from .synthetic import image_task, lm_batches, markov_table, token_stats
from .pipeline import Prefetcher, checked_iterator, shard_batch

__all__ = ["image_task", "lm_batches", "markov_table", "token_stats",
           "Prefetcher", "checked_iterator", "shard_batch"]
