"""Data-plane transfers between replicas (``kv_transfer``)."""
