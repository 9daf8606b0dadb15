"""KV-aware routing: the port's copy of ``dynamo_tpu/kv_router``."""
