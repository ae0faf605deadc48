"""Serving plane: request queue, tenancy, radix KV cache, speculation
and the continuous-batching engines (``serving.engine``, imported
lazily by callers so the lightweight modules stay cheap to import)."""
