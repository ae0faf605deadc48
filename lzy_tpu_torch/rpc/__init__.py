"""The RPC layer's error types the serving fronts raise (``core``)."""
