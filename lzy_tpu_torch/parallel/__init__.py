"""Training steps on one device (the port of ``lzy_tpu/parallel``)."""
