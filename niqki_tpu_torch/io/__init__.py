"""Input readers and output writers of the port (counterparts of
``niqki_tpu/io``)."""
