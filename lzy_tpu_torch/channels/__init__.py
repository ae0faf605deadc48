"""Data-plane transfers: KV blocks between replicas (``kv_transfer``),
op values between workers (``manager``) and token streams
(``token_stream``)."""
