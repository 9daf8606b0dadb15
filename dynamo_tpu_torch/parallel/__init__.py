"""Sequence parallelism for long-context prefill, with the ``sp`` ranks laid
out on one device as the leading dimension of the query shard."""
